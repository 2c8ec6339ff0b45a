"""Hot concurrent scenarios for the deterministic schedule fuzzer.

Counterpart of ``mxnet_tpu/analysis/schedules.py``: the same six
scenarios over the port's classes.  Each scenario is a callable
``fn(seed, audit, device)`` executed inside an
``audit_threads(fuzzer=ScheduleFuzzer(seed), record=False)`` window by
:func:`mxnet_tpu_torch.analysis.concurrency.run_schedules`: every lock /
queue / tracked-container boundary the window instruments becomes a
seeded preemption point, so successive seeds drive the same code
through different thread interleavings.  The scenario body *asserts its
own invariant* — byte-identity of token streams, restore-equals-
snapshot for checkpoints, parseability of telemetry files — and a
failing seed is a replayable repro (``run_schedules([name], n=1,
seed=that_seed)``).

* ``flight_dump_during_append`` — FlightRecorder.dump while another
  thread appends;
* ``emitter_snapshot_race`` — JsonlEmitter.maybe_snapshot from trainer
  + checkpoint-writer threads (the ``_last`` check-then-set race);
* ``ckpt_save_during_step`` — CheckpointManager.save's synchronous
  snapshot racing in-place "train step" mutation of the live tensors
  on ``device``: on the card a kernel on the current stream writes them
  right after ``save()`` returns, so a copy from the card that had not
  landed when the snapshot returned would change the bytes saved;
* ``failover_during_decode`` — replica crash mid-decode while a client
  thread streams and the main thread drives the router;
* ``rolling_swap_under_live_streams`` — Router.rolling_swap racing a
  client thread pulling tokens;
* ``heartbeat_drain_race`` — heartbeat-declared death racing an
  operator drain of the same (hung) replica.

The three host scenarios need no card.  The serve scenarios build a
router of tiny engines (V=61, 2 layers, d=32) on ``device``; on the card
each replica's warmup captures its programs as CUDA graphs, and the
decode steps replay them (flash decode, K5, inside the graphs).  A
program belongs to the engine that captured it, so every fuzzed router
captures again (the JAX package reuses its global compile cache
instead).  The byte-identity reference is computed once per process and
device on an idle (single-threaded) pass and cached.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
from typing import Callable, Dict, List

import numpy as np

_SCENARIOS: Dict[str, Callable] = {}


def scenario(name: str):
    def deco(fn):
        _SCENARIOS[name] = fn
        return fn
    return deco


def names() -> List[str]:
    return sorted(_SCENARIOS)


def get(name: str) -> Callable:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown schedule scenario {name!r}; "
                       f"have {names()}") from None


# ----------------------------------------------------------------------
# Host scenarios (telemetry, checkpoints)
# ----------------------------------------------------------------------

@scenario("flight_dump_during_append")
def flight_dump_during_append(seed: int, audit, device) -> None:
    """One thread appends step records, the main thread dumps the ring
    mid-append.  Invariant: every dump is valid JSON whose record list
    is a clean prefix-free slice (no torn/duplicated entries), and the
    final ring holds exactly the newest ``capacity`` records."""
    from ..telemetry.flight import FlightRecorder
    fr = FlightRecorder(capacity=32)
    audit.wrap_lock(fr, "_lock", "FlightRecorder._lock")
    n_total = 120
    done = threading.Event()
    # dozens of dumps per run: keep the per-dump warning line out of CI
    flog = logging.getLogger("mxnet_tpu_torch.telemetry.flight")
    old_level = flog.level
    flog.setLevel(logging.ERROR)

    def appender():
        for i in range(n_total):
            fr.record({"step": i, "loss": float(i)})
        done.set()

    t = threading.Thread(target=appender, name="flight-appender")
    t.start()
    try:
        with tempfile.TemporaryDirectory(prefix="mxtpu_conc_") as td:
            dumps = []
            while not done.is_set():
                p = os.path.join(td, f"d{len(dumps)}.json")
                fr.dump("fuzz", path=p)
                dumps.append(p)
                if len(dumps) > 64:   # appender starved by preemptions
                    break
            t.join()
            for p in dumps:
                with open(p) as fh:
                    payload = json.load(fh)
                recs = payload["records"]
                assert len(recs) <= 32
                steps = [r["step"] for r in recs]
                # a consistent snapshot is a contiguous, strictly
                # increasing window of the append sequence
                assert steps == list(range(steps[0] if steps else 0,
                                           (steps[0] if steps else 0)
                                           + len(steps))), \
                    f"torn flight dump: {steps}"
    finally:
        flog.setLevel(old_level)
    final = [r["step"] for r in fr.records()]
    assert final == list(range(n_total - 32, n_total))


@scenario("emitter_snapshot_race")
def emitter_snapshot_race(seed: int, audit, device) -> None:
    """Trainer + checkpoint-writer threads both tick counters and call
    ``maybe_snapshot``/``emit`` on one JsonlEmitter.  Invariant: the
    output file is line-wise valid JSON (no interleaved writes) and the
    throttle never emits two snapshots for one interval."""
    from ..telemetry.metrics import JsonlEmitter, Registry
    reg = Registry()
    audit.wrap_lock(reg, "_lock", "Registry._lock")
    with tempfile.TemporaryDirectory(prefix="mxtpu_conc_") as td:
        path = os.path.join(td, "metrics.jsonl")
        em = JsonlEmitter(path, interval=0.0)   # every call is eligible
        audit.wrap_lock(em, "_lock", "JsonlEmitter._lock")

        def worker(tag):
            for i in range(40):
                reg.counter(f"fuzz.{tag}").inc()
                em.maybe_snapshot(reg)
                em.emit("step", {"tag": tag, "i": i})

        ts = [threading.Thread(target=worker, args=(k,),
                               name=f"emitter-{k}") for k in ("a", "b")]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        with open(path) as fh:
            lines = fh.read().splitlines()
        assert lines, "emitter produced no output"
        flat = {}
        for ln in lines:
            rec = json.loads(ln)     # torn write -> JSONDecodeError
            assert "kind" in rec
            if rec["kind"] == "metrics":
                flat = rec
        assert flat, "no metrics snapshot emitted"


def _host_bytes(x) -> bytes:
    """The bytes of a tensor (copied off the card) or a host array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


@scenario("ckpt_save_during_step")
def ckpt_save_during_step(seed: int, audit, device) -> None:
    """Async checkpoint save racing in-place mutation by the "train
    step": ``save()`` snapshots synchronously, so whatever the writer
    thread commits must equal the tensors as they were at the save call
    — byte-identical — no matter how the schedule interleaves the
    writer with subsequent mutation.  On the card the mutation is a
    kernel on the current stream, queued right after ``save()``
    returns."""
    import torch
    from ..checkpoint.manager import CheckpointManager
    arrays = {"w": torch.arange(64, dtype=torch.float32, device=device),
              "b": torch.ones((8,), dtype=torch.float32, device=device)}
    with tempfile.TemporaryDirectory(prefix="mxtpu_conc_") as td:
        mgr = CheckpointManager(td, keep_last=5, async_write=True)
        expected = {}
        for step in range(3):
            expected[step] = {k: (tuple(v.shape), _host_bytes(v))
                              for k, v in arrays.items()}
            mgr.save(step, arrays)
            # the next "train steps" mutate the live buffers in place
            # while the writer thread serializes its snapshot
            with torch.no_grad():
                for k in arrays:
                    arrays[k].add_(1.0)
        mgr.wait_until_finished()
        for step, want in expected.items():
            got, _meta, got_step = mgr.restore(step=step)
            assert got_step == step
            for k, (shape, raw) in want.items():
                g = np.asarray(got[k])
                assert g.dtype == np.float32 and g.shape == shape \
                    and _host_bytes(g) == raw, \
                    f"step {step} array {k} not byte-identical"
        mgr.close()


# ----------------------------------------------------------------------
# Serve scenarios (tiny engines on the scenario's device)
# ----------------------------------------------------------------------

_V, _NL, _D, _H = 61, 2, 32, 4
_ECFG = dict(heads=_H, block_size=4, num_blocks=64, max_batch=4,
             max_prompt_len=16, max_seq_len=32, prompt_bucket_min=8)
_PROMPTS = [[3, 14, 15, 9, 2], [27, 1, 8, 2], [6, 28, 31, 8, 5, 3]]
_KW = [dict(max_new_tokens=6, temperature=(0.7 if i % 2 else 0.0),
            top_k=(5 if i % 2 else 0), seed=200 + i)
       for i in range(len(_PROMPTS))]

_params_cache: Dict[str, np.ndarray] = {}
_ref_cache: Dict[str, list] = {}


def _params() -> dict:
    """The JAX scenarios' weights: ``RandomState(0).randn * 0.05`` in
    the transformer-LM symbol's argument order."""
    if not _params_cache:
        from ..models.transformer import init_params
        _params_cache.update(init_params(_V, _NL, _D, seed=0))
    return _params_cache


def _router(device, chaos=None, clock=None, replicas=2, hb_ms=None):
    from ..serve import EngineConfig, Router, RouterConfig
    kw = {} if clock is None else {"clock": clock}
    rcfg = (RouterConfig(replicas=replicas) if hb_ms is None else
            RouterConfig(replicas=replicas, heartbeat_timeout_ms=hb_ms))
    return Router(_params(), EngineConfig(**_ECFG), rcfg,
                  chaos=chaos or {}, device=device, **kw)


def _reference(device) -> list:
    """Clean single-threaded streams every fuzzed run on ``device`` must
    reproduce.  Computed once per process and device; preemption sleeps
    cannot perturb a single-threaded drive, so computing it inside the
    first fuzz window is safe."""
    key = str(device)
    if key not in _ref_cache:
        router = _router(device)
        router.warmup()
        ids = [router.submit(p, **k) for p, k in zip(_PROMPTS, _KW)]
        router.run()
        _ref_cache[key] = [list(router.request(i).tokens) for i in ids]
    return _ref_cache[key]


class _Clock:
    def __init__(self):
        self.t = 0.0
        self._mu = threading.Lock()

    def __call__(self):
        with self._mu:
            return self.t

    def advance(self, dt):
        with self._mu:
            self.t += dt


@scenario("failover_during_decode")
def failover_during_decode(seed: int, audit, device) -> None:
    """Replica 0 crashes at its 4th step while a client thread streams
    a request placed on it and the main thread drives the fleet.  Both
    threads call ``Router.step`` concurrently (the router's RLock is a
    fuzz preemption point).  Invariant: every merged stream is
    byte-identical to the clean run."""
    from ..chaos import ChaosSpec
    ref = _reference(device)
    router = _router(device, chaos={0: ChaosSpec({"serve_crash": {4}})})
    audit.instrument_router(router)
    router.warmup()
    ids = [router.submit(p, **k) for p, k in zip(_PROMPTS, _KW)]
    victim = next(i for i in ids
                  if router.request(i).replica is not None
                  and router.request(i).replica.idx == 0)
    streamed: List[int] = []

    def client():
        for tok in router.stream(victim):
            streamed.append(tok)

    t = threading.Thread(target=client, name="serve-client")
    t.start()
    router.run()
    t.join()
    assert streamed == ref[ids.index(victim)]
    assert [list(router.request(i).tokens) for i in ids] == ref


@scenario("rolling_swap_under_live_streams")
def rolling_swap_under_live_streams(seed: int, audit, device) -> None:
    """Zero-downtime weight deploy racing a live client: the swap
    installs the *same* params (hot path: copies into the captured
    storage, no capture), so the streams must stay byte-identical
    through the drain/redeploy dance."""
    ref = _reference(device)
    router = _router(device)
    audit.instrument_router(router)
    router.warmup()
    ids = [router.submit(p, **k) for p, k in zip(_PROMPTS, _KW)]
    done = threading.Event()

    def client():
        try:
            router.run()
        finally:
            done.set()

    t = threading.Thread(target=client, name="serve-client")
    t.start()
    router.rolling_swap(_params())
    t.join()
    assert done.is_set()
    assert [list(router.request(i).tokens) for i in ids] == ref


@scenario("heartbeat_drain_race")
def heartbeat_drain_race(seed: int, audit, device) -> None:
    """Replica 0 hangs; an ops thread advances the fake clock past the
    heartbeat timeout while the main thread races an operator
    ``drain(0)`` against the death declaration.  Whichever wins, every
    request must finish with byte-identical tokens; losing the race
    raises the documented typed error, never corrupts state."""
    from ..base import MXNetError
    from ..chaos import ChaosSpec
    ref = _reference(device)
    clk = _Clock()
    router = _router(device, chaos={0: ChaosSpec({"serve_hang": {3}})},
                     clock=clk, hb_ms=500)
    audit.instrument_router(router)
    router.warmup()
    ids = [router.submit(p, **k) for p, k in zip(_PROMPTS, _KW)]

    def ops():
        for _ in range(4):
            router.step()
        clk.advance(1.0)          # past the 500 ms heartbeat timeout

    t = threading.Thread(target=ops, name="serve-ops")
    t.start()
    try:
        router.drain(0)           # races the heartbeat death
    except MXNetError:
        pass                      # lost the race: replica already dead
    t.join()
    router.run()
    assert [list(router.request(i).tokens) for i in ids] == ref
    assert all(router.request(i).state == "finished" for i in ids)
