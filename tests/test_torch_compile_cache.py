"""The program cache of the PyTorch port (mxnet_tpu_torch/compile_cache.py)
against the JAX package's, on the CPU.

The JAX side compiles XLA executables; the port's programs are captured
CUDA graphs on the card and, on the CPU, the same static-buffer programs
run eagerly (source ``"eager"``), so these tests hold the plumbing to the
eager path and to the JAX package:

* program keys: sensitive to exactly the mutations JAX's keys are
  sensitive to, stable on re-keying; the graph fingerprint is the JAX
  digest byte for byte on the zoo's symbols and blind to node names;
* the LRU, the disabled cache and the env auto-configuration give the JAX
  cache's hits and misses on the same sequence of keys;
* a compiled trainer (mlp, lenet, the LM; fused and unfused) steps
  bitwise as the port's eager trainer and within the trainer tolerances
  (rtol 1e-4, atol 1e-6 on parameters, atol 1e-5 on heads; f32 summation
  order differs between XLA and ATen) of the JAX trainer's compiled
  steps; ``compile()`` and a program's warm-up leave the state as they
  found it; a second trainer misses where JAX's hits (by design: a graph
  reads its owner's storage);
* ``Engine.warmup()`` resolves JAX's programs and serves its greedy
  streams; a hot swap keeps the programs;
* ``Executor.warmup``, ``Module.compile``, ``BucketingModule.compile`` and
  ``FeedForward.compile`` resolve the JAX counterparts' programs and give
  their outputs.
"""
import contextlib
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import compile_cache as jcc
from mxnet_tpu import models as jmodels
from mxnet_tpu import random as jrandom
from mxnet_tpu.graph_eval import graph_fingerprint as jfingerprint
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh
from mxnet_tpu.serve import Engine as JaxEngine
from mxnet_tpu.serve import EngineConfig as JaxEngineConfig

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import _build
from mxnet_tpu_torch import compile_cache as cc
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.graph_eval import graph_fingerprint
from mxnet_tpu_torch.models.transformer import init_params
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.serve import Engine, EngineConfig

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEAD_ATOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _isolate():
    """Fresh global caches (both packages), the build directory and the
    JAX package's PRNG as they were."""
    saved = dict(jrandom._state)
    build_dir = _build._dir_override
    ttel.reset_for_tests()
    yield
    cc.configure(cache_dir=None)
    jcc.configure(cache_dir=None)
    _build._dir_override = build_dir
    jrandom._state.update(saved)
    ttel.reset_for_tests()


# ---------------------------------------------------------------------------
# Keys and the fingerprint
# ---------------------------------------------------------------------------

def _t(shape, dtype=torch.float32, device="cpu"):
    return torch.empty(shape, dtype=dtype, device=device)


def _j(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


# the mutations of JAX's test_program_key_sensitivity, each on both sides
MUTATIONS = {
    "fingerprint": (lambda k: k("OTHER", (4, 8), "f32", (0,), None)),
    "shape": (lambda k: k("fp", (4, 16), "f32", (0,), None)),
    "dtype": (lambda k: k("fp", (4, 8), "bf16", (0,), None)),
    "donation": (lambda k: k("fp", (4, 8), "f32", (), None)),
    "hyper": (lambda k: k("fp", (4, 8), "f32", (0,), {"lr": 0.2})),
}


def _jax_key(fp, shape, dt, donate, extra):
    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    return jcc.program_key(fp, [_j(shape, dtype)], donate=donate,
                           extra=extra)


def _port_key(fp, shape, dt, donate, extra):
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    return cc.program_key(fp, [_t(shape, dtype)], donate=donate,
                          extra=extra)


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_program_key_sensitivity_matches_jax(mutation):
    for key in (_jax_key, _port_key):
        base = key("fp", (4, 8), "f32", (0,), None)
        assert MUTATIONS[mutation](key) != base, key.__name__


def test_program_key_stable_and_readable():
    a = cc.program_key("fp", [_t((4, 8))], donate=(0,), extra={"lr": 0.1})
    b = cc.program_key("fp", [_t((4, 8))], donate=(0,), extra={"lr": 0.1})
    assert a == b and hash(a) == hash(b) and a.digest == b.digest
    fields = a.describe()
    assert fields["fingerprint"] == "fp" and fields["x:lr"] == "0.1"
    assert fields["backend"] == cc.backend_of() and "torch=" in \
        fields["versions"]
    # the same fields hash the JAX way: sha256 over the sorted fields
    assert cc.CacheKey(fields).digest == jcc.CacheKey(fields).digest
    # the device and the owner are part of a port key
    assert cc.program_key("fp", [_t((4, 8), device="meta")]) != \
        cc.program_key("fp", [_t((4, 8))])
    assert cc.program_key("fp", extra={"owner": "a"}) != \
        cc.program_key("fp", extra={"owner": "b"})
    # a mesh is part of the key (the JAX package's fingerprint string);
    # anything else in its place is refused
    mesh = mxt.parallel.make_mesh({"data": 2}, [mxt.cpu(0), mxt.cpu(1)])
    assert cc.program_key("fp", mesh=mesh) != cc.program_key("fp")
    assert cc.program_key("fp", mesh=mesh).describe()["mesh"] == \
        cc.mesh_fingerprint(mesh)
    with pytest.raises(MXNetError, match="Mesh"):
        cc.program_key("fp", mesh=object())


def test_owner_tokens_are_never_reused():
    class Owner:
        pass
    toks = set()
    for _ in range(50):
        o = Owner()             # ids are reused as owners die; tokens not
        toks.add(cc.owner_token(o))
        assert cc.owner_token(o) == cc.owner_token(o)
    assert len(toks) == 50


ZOO = ("mlp", "lenet", "resnet", "alexnet", "vgg", "googlenet",
       "inception-bn", "inception-bn-28-small")


@pytest.mark.parametrize("name", ZOO + ("transformer-lm",))
def test_graph_fingerprint_equals_jax(name):
    kw = (dict(vocab_size=61, num_layers=2, d_model=32, heads=2,
               batch_size=2, seq_len=128, loss_head=True)
          if name == "transformer-lm" else dict(num_classes=10))
    with mx.name.NameManager(), mxt.name.NameManager():
        j = jmodels.get_symbol(name, **kw)
        t = tmodels.get_symbol(name, **kw)
    assert graph_fingerprint(t) == jfingerprint(j)


def test_graph_fingerprint_blind_to_names():
    def named(S, h, prefix):
        net = S.FullyConnected(data=S.Variable("data"), num_hidden=h,
                               name=prefix + "1")
        net = S.Activation(data=net, act_type="relu")
        net = S.FullyConnected(data=net, num_hidden=10, name=prefix + "2")
        return S.SoftmaxOutput(data=net, name=prefix + "sm")
    S = mxt.symbol
    assert graph_fingerprint(named(S, 32, "a")) == \
        graph_fingerprint(named(S, 32, "b"))
    assert graph_fingerprint(named(S, 33, "a")) != \
        graph_fingerprint(named(S, 32, "a"))
    assert graph_fingerprint(named(S, 32, "x")) == \
        jfingerprint(named(mx.symbol, 32, "y"))


# ---------------------------------------------------------------------------
# ProgramCache against the JAX cache
# ---------------------------------------------------------------------------

class _Prog:
    """A stand-in program (weakly referable, as CapturedProgram is)."""
    source = "eager"


# a sequence of key indices: misses fill a capacity-2 LRU, hits refresh
SEQUENCE = [0, 1, 0, 2, 1, 0, 2, 2, 3, 0]


@pytest.mark.parametrize("enabled", [True, False], ids=["lru", "disabled"])
def test_cache_hits_and_misses_equal_jax(enabled):
    jc = jcc.ProgramCache(max_entries=2, enabled=enabled)
    tc = cc.ProgramCache(max_entries=2, enabled=enabled)
    keep = []

    def make():
        keep.append(_Prog())
        return keep[-1]

    jseq, tseq = [], []
    for i in SEQUENCE:
        jk = jcc.program_key(f"k{i}", [_j((4,))])
        tk = cc.program_key(f"k{i}", [_t((4,))])
        _, ji = jc.get_or_compile(jk, make, label="t")
        _, ti = tc.get_or_compile(tk, make, label="t")
        jseq.append(ji["source"])
        tseq.append(ti["source"])
    assert [s if s == "memory" else "miss" for s in tseq] == \
        [s if s == "memory" else "miss" for s in jseq]
    assert tc.stats == jc.stats
    assert (jc.stats["memory_hits"] > 0) == enabled


def test_cache_drops_programs_of_owners_gone():
    tc = cc.ProgramCache()
    key = cc.program_key("gone")
    prog, info = tc.get_or_compile(key, _Prog)
    assert info["source"] == "eager"
    assert tc.lookup(key) is prog
    del prog
    assert tc.lookup(key) is None       # held weakly: its owner is gone


def test_get_cache_env_auto_configure_equals_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TPU_CACHE_DIR", str(tmp_path / "c"))
    monkeypatch.setenv("MXNET_TPU_CACHE_MAX_ENTRIES", "7")
    for m in (jcc, cc):
        m._global["cache"] = None
    got = [(m.get_cache().cache_dir, m.get_cache().max_entries,
            m.get_cache().enabled) for m in (jcc, cc)]
    assert got[0] == got[1] == (str(tmp_path / "c"), 7, True)
    # the kernel builds follow the cache directory
    assert _build.build_dir() == tmp_path / "c" / "cuda"
    monkeypatch.setenv("MXNET_TPU_CACHE", "0")
    for m in (jcc, cc):
        m._global["cache"] = None
    assert not jcc.get_cache().enabled and not cc.get_cache().enabled


def test_sidecars_entries_and_evict(tmp_path):
    tc = cc.configure(cache_dir=str(tmp_path))
    assert _build.build_dir() == tmp_path / "cuda"
    keys = [cc.program_key(f"side{i}", [_t((4,))]) for i in range(2)]
    keep = [tc.get_or_compile(k, _Prog, label=f"p{i}")[0]
            for i, k in enumerate(keys)]
    ents = tc.entries()
    assert sorted(e["digest"] for e in ents) == sorted(k.digest
                                                       for k in keys)
    assert {e["label"] for e in ents} == {"p0", "p1"}
    assert ents[0]["fields"]["fingerprint"].startswith("side")
    # a graph has no payload: the sidecar is the whole disk entry
    assert not [n for n in os.listdir(tmp_path / "programs")
                if not n.endswith(".json")]
    assert tc.evict(keys[0].digest[:10])
    assert [e["digest"] for e in tc.entries()] == [keys[1].digest]
    assert tc.lookup(keys[0]) is None and tc.lookup(keys[1]) is keep[1]
    tc.clear()
    assert tc.entries() == []


def test_launch_counts_of_a_capture_move_to_its_replays():
    """The bookkeeping :class:`CapturedProgram` applies around a capture:
    the counts a capture added are taken back and added per replay."""
    from mxnet_tpu_torch.ops import nn_ops
    f = nn_ops.softmax_rows
    saved = (f.launches, dict(f.launches_by_form))
    try:
        before = cc._counter_snapshot()
        f.launches += 2
        f.launches_by_form["warp"] += 2
        delta = cc._counter_delta(before, cc._counter_snapshot())
        assert sorted((a, k, d) for _, a, k, d in delta) == [
            ("launches", None, 2), ("launches_by_form", "warp", 2)]
        cc._apply_delta(delta, -1)
        assert (f.launches, f.launches_by_form) == saved
        for _ in range(3):
            cc._apply_delta(delta, +1)
        assert f.launches == saved[0] + 6
        assert f.launches_by_form["warp"] == saved[1]["warp"] + 6
    finally:
        f.launches, f.launches_by_form = saved[0], saved[1]


def test_captured_program_on_the_cpu_runs_its_body():
    calls = []
    buf = torch.zeros(3)

    def body():
        calls.append(1)
        return buf * 2
    prog = cc.CapturedProgram("t", body, "cpu", inputs={"x": buf}).build()
    assert prog.source == "eager" and prog.graph is None
    prog.stage({"x": torch.tensor([1.0, 2.0, 3.0])})
    assert prog().tolist() == [2.0, 4.0, 6.0] and len(calls) == 1
    # an uncapturable program says so and is counted
    bad = cc.CapturedProgram("u", body, "cpu", reason="why").build()
    assert bad.source == "eager" and bad.reason == "why"
    assert ttel.registry().get_value("compile_cache.uncaptured") == 1


# ---------------------------------------------------------------------------
# ShardedTrainer.compile
# ---------------------------------------------------------------------------

BATCH = 16
NETS = {"mlp": ((784,), lambda m: m.mlp()),
        "lenet": ((1, 28, 28), lambda m: m.lenet())}
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def _build_net(net):
    with mx.name.NameManager(), mxt.name.NameManager():
        return NETS[net][1](jmodels), NETS[net][1](tmodels)


def _args(sym, shape, seed=0):
    shapes, _, _ = sym.infer_shape(data=(BATCH,) + shape,
                                   softmax_label=(BATCH,))
    rng = np.random.RandomState(seed)
    return {n: (0.05 * rng.randn(*s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _port_trainer(tsym, args, shape, fused=None, seed=0, **kw):
    tt = ShardedTrainer(tsym, optimizer="sgd", optimizer_params=dict(OPT),
                        guard=True, clip_global_norm=0.5,
                        fused_update=fused, device="cpu", seed=seed, **kw)
    tt.bind(data_shapes={"data": (BATCH,) + shape},
            label_shapes={"softmax_label": (BATCH,)}, arg_params=args)
    return tt


def _jax_trainer(jsym, args, shape):
    jt = JaxTrainer(jsym, optimizer="sgd", optimizer_params=dict(OPT),
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]),
                    guard=True, clip_global_norm=0.5)
    jt.bind(data_shapes={"data": (BATCH,) + shape},
            label_shapes={"softmax_label": (BATCH,)},
            arg_params={k: jnp.asarray(v) for k, v in args.items()})
    return jt


def _batches(shape, n, seed=1):
    rng = np.random.RandomState(seed)
    return [{"data": rng.rand(BATCH, *shape).astype(np.float32),
             "softmax_label": rng.randint(0, 10, BATCH).astype(np.float32)}
            for _ in range(n)]


def _state(tr):
    """Every tensor of a port trainer's state, as numpy, plus the count."""
    out = {f"t{i}": t.detach().clone().numpy()
           for i, t in enumerate(tr._state_tensors())}
    out["num_update"] = tr._num_update
    return out


def _same_state(a, b):
    return sorted(a) == sorted(b) and all(
        np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_compiled_trainer_bitwise_eager_and_close_to_jax(net, fused):
    shape = NETS[net][0]
    jsym, tsym = _build_net(net)
    args = _args(tsym, shape)
    eager = _port_trainer(tsym, args, shape, fused)
    comp = _port_trainer(tsym, args, shape, fused)
    jt = _jax_trainer(jsym, args, shape)
    before = _state(comp)
    infos = comp.compile(programs=("train", "eval"))
    jinfos = jt.compile(programs=("train", "eval"))
    assert [i["kind"] for i in infos] == [i["kind"] for i in jinfos]
    assert {i["source"] for i in infos} == {"eager"}
    assert _same_state(_state(comp), before)
    batches = _batches(shape, 4)
    for i, b in enumerate(batches):
        he, hc, hj = eager.step(b), comp.step(b), jt.step(b)
        assert torch.equal(he[0], hc[0]), f"step {i}"
        np.testing.assert_allclose(hc[0].numpy(), np.asarray(hj[0]),
                                   rtol=0, atol=HEAD_ATOL)
    assert _same_state(_state(comp), _state(eager))
    assert comp.aot_stats == {"hits": 4, "fallbacks": 0}
    assert jt.aot_stats["hits"] == 4
    jargs, _ = jt.get_params()
    targs, _ = comp.get_params()
    for n in jargs:
        np.testing.assert_allclose(targs[n].asnumpy(), jargs[n].asnumpy(),
                                   err_msg=n, **PARAM_TOL)
    assert torch.equal(comp.forward(batches[0])[0],
                       eager.forward(batches[0])[0])
    assert comp.aot_stats["hits"] == 5


def test_compiled_lm_trainer_bitwise_eager():
    kw = dict(vocab_size=61, num_layers=2, d_model=32, heads=2,
              batch_size=2, seq_len=128, attn_block_size=64, loss_head=True)
    with mxt.name.NameManager():
        tsym = tmodels.get_symbol("transformer-lm", **kw)
    rng = np.random.RandomState(0)

    def trainer():
        tr = ShardedTrainer(tsym, "adam", {"learning_rate": 1e-3},
                            guard=True, clip_global_norm=1.0,
                            device="cpu", seed=3)
        tr.bind({"data": (2, 128)}, {"softmax_label": (2, 128)})
        return tr
    eager, comp = trainer(), trainer()
    before = _state(comp)
    assert comp.compile()[0]["source"] == "eager"
    assert _same_state(_state(comp), before)
    for _ in range(3):
        tok = rng.randint(0, 61, (2, 129)).astype(np.float32)
        b = {"data": tok[:, :-1], "softmax_label": tok[:, 1:]}
        assert torch.equal(eager.step(b)[0], comp.step(b)[0])
    assert _same_state(_state(comp), _state(eager))
    assert comp.aot_stats["hits"] == 3


@pytest.mark.parametrize("kind", ["train", "train_acc", "eval"])
def test_program_warmup_is_undone(kind):
    """What a program's warm-up runs on the card (its body, twice) leaves
    the trainer bitwise as it was once ``preserve``'s restore runs."""
    jsym, tsym = _build_net("mlp")
    tr = _port_trainer(tsym, _args(tsym, (784,)), (784,))
    tr.step(_batches((784,), 1)[0])     # momentum and guard state live
    tr.compile(programs=(kind,))
    prog = tr._aot[kind][0]
    prog.stage({n: torch.from_numpy(v)
                for n, v in _batches((784,), 1, seed=5)[0].items()})
    before = _state(tr)
    restore = prog.preserve()
    for _ in range(prog.warmup_iters):
        prog.body()
    assert kind == "eval" or not _same_state(_state(tr), before)
    restore()
    assert _same_state(_state(tr), before)


def test_second_trainer_misses_where_jax_hits():
    """By design: a JAX executable takes the parameters as arguments, a
    graph reads its owner's storage, so only the same trainer hits."""
    shape = NETS["mlp"][0]
    jsym, tsym = _build_net("mlp")
    args = _args(tsym, shape)
    j1, j2 = _jax_trainer(jsym, args, shape), _jax_trainer(jsym, args, shape)
    t1 = _port_trainer(tsym, args, shape)
    t2 = _port_trainer(tsym, args, shape)
    ji = [j.compile()[0] for j in (j1, j2)]
    ti = [t.compile()[0] for t in (t1, t2)]
    assert [i["source"] for i in ji] == ["compile", "memory"]
    assert ji[0]["digest"] == ji[1]["digest"]
    assert [i["source"] for i in ti] == ["eager", "eager"]
    assert ti[0]["digest"] != ti[1]["digest"]
    # a re-compile of the same trainer is a hit, on the same program
    again = t1.compile()[0]
    assert again["source"] == "memory" and again["digest"] == ti[0]["digest"]
    assert t1._aot["train"][0] is not t2._aot["train"][0]


def test_background_compile_equals_foreground():
    shape = NETS["lenet"][0]
    _, tsym = _build_net("lenet")
    args = _args(tsym, shape)
    fg = _port_trainer(tsym, args, shape)
    bg = _port_trainer(tsym, args, shape)
    fg.compile(programs=("train",))
    th = bg.compile(programs=("train",), background=True)
    assert isinstance(th, threading.Thread)
    th.join(timeout=120)
    assert not th.is_alive()
    assert bg.compile_info[0]["kind"] == "train"
    for b in _batches(shape, 2):
        assert torch.equal(fg.step(b)[0], bg.step(b)[0])
    assert bg.aot_stats["hits"] == 2


def test_batch_signature_mismatch_runs_eagerly():
    shape = NETS["mlp"][0]
    _, tsym = _build_net("mlp")
    args = _args(tsym, shape)
    eager = _port_trainer(tsym, args, shape)
    comp = _port_trainer(tsym, args, shape)
    comp.compile(batch_spec={"data": ((BATCH,) + shape, np.float64),
                             "softmax_label": ((BATCH,), np.float32)})
    b = _batches(shape, 1)[0]
    assert torch.equal(eager.step(b)[0], comp.step(b)[0])
    assert comp.aot_stats == {"hits": 0, "fallbacks": 1}
    assert "train" not in comp._aot


def test_sampling_graph_program_runs_eagerly_with_reason():
    S = mxt.symbol
    with mxt.name.NameManager():
        net = S.FullyConnected(data=S.Variable("data"), num_hidden=16,
                               name="fc1")
        net = S.Dropout(data=net, p=0.5)
        net = S.FullyConnected(data=net, num_hidden=10, name="fc2")
        sym = S.SoftmaxOutput(data=net, name="softmax")
    args = _args(sym, (8,))

    def trainer():
        tr = ShardedTrainer(sym, "sgd", {"learning_rate": 0.1},
                            device="cpu", seed=4)
        tr.bind({"data": (BATCH, 8)}, {"softmax_label": (BATCH,)},
                arg_params=args)
        return tr
    eager, comp = trainer(), trainer()
    info = comp.compile()[0]
    assert info["source"] == "eager" and "Dropout" in info["reason"]
    assert ttel.registry().get_value("compile_cache.uncaptured") == 1
    for b in _batches((8,), 2):
        assert torch.equal(eager.step(b)[0], comp.step(b)[0])


def test_persistent_cache_across_processes(tmp_path):
    """A process with ``MXNET_TPU_CACHE_DIR`` writes its programs'
    sidecars; a second one lists them (graphs are captured anew: the
    owner tokens differ, so its own keys are new)."""
    child = textwrap.dedent("""
        import json
        import numpy as np
        import mxnet_tpu_torch as mxt
        from mxnet_tpu_torch import _build, compile_cache as cc
        from mxnet_tpu_torch.parallel import ShardedTrainer
        S = mxt.symbol
        net = S.FullyConnected(data=S.Variable("data"), num_hidden=8,
                               name="fc1")
        sym = S.SoftmaxOutput(data=net, name="softmax")
        tr = ShardedTrainer(sym, "sgd", {"learning_rate": 0.1},
                            device="cpu")
        tr.bind({"data": (4, 6)}, {"softmax_label": (4,)})
        info = tr.compile()[0]
        seen = sorted(e["digest"] for e in cc.get_cache().entries())
        print(json.dumps({"digest": info["digest"], "seen": seen,
                          "build_dir": str(_build.build_dir())}))
    """)
    env = dict(os.environ, MXNET_TPU_CACHE_DIR=str(tmp_path),
               PYTHONPATH=REPO_ROOT)

    def run():
        out = subprocess.run([sys.executable, "-c", child], env=env,
                             capture_output=True, text=True, timeout=240,
                             cwd=REPO_ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    cold, warm = run(), run()
    assert cold["seen"] == [cold["digest"]]
    assert sorted(warm["seen"]) == sorted([cold["digest"], warm["digest"]])
    assert cold["build_dir"] == str(tmp_path / "cuda")


# ---------------------------------------------------------------------------
# Engine.warmup
# ---------------------------------------------------------------------------

V, NL, D, H = 61, 2, 32, 2
CFG = dict(heads=H, block_size=8, num_blocks=64, max_batch=4,
           max_seq_len=96, max_prompt_len=48)
PROMPTS = [[(7 * i + 3 * j) % (V - 1) + 1 for j in range(n)]
           for i, n in enumerate((5, 17, 30, 9))]


def _serve(eng, prompts, **kw):
    ids = [eng.submit(p, max_new_tokens=10, **kw) for p in prompts]
    return [eng.result(i) for i in ids]


@pytest.mark.parametrize("over", [
    {}, dict(prefill_chunk=16), dict(prefill_chunk=16, kv_quant="fp8"),
    dict(prefill_chunk=16, speculate=True, spec_k=3)],
    ids=["whole", "chunked", "fp8", "speculate"])
def test_engine_warmup_programs_and_streams_equal_jax(over):
    params = init_params(V, NL, D, seed=0)
    jeng = JaxEngine(params, JaxEngineConfig(**dict(CFG, **over)))
    eng = Engine(params, EngineConfig(**dict(CFG, **over)), device="cpu")
    jinfos, infos = jeng.warmup(), eng.warmup()
    assert [(i["kind"], i["bucket"]) for i in infos] == \
        [(i["kind"], i["bucket"]) for i in jinfos]
    for i in infos:
        assert i["source"] == "eager"
        assert set(i) >= {"source", "seconds", "digest", "kind", "bucket"}
    assert eng.aot_stats["eager"] == len(infos)
    assert _serve(eng, PROMPTS) == _serve(jeng, PROMPTS)
    assert eng.aot_stats["replays"] > 0
    # a second warmup resolves the same programs from memory
    again = eng.warmup()
    assert {i["source"] for i in again} == {"memory"}
    assert [i["digest"] for i in again] == [i["digest"] for i in infos]


def test_engine_program_streams_equal_eager_sampled():
    params = init_params(V, NL, D, seed=0)
    cold = Engine(params, EngineConfig(**CFG), device="cpu")
    warm = Engine(params, EngineConfig(**CFG), device="cpu")
    warm.warmup()
    kw = dict(temperature=0.9, top_k=8, seed=11)
    assert _serve(warm, PROMPTS, **kw) == _serve(cold, PROMPTS, **kw)


def test_engine_swap_keeps_programs_and_callers_arrays():
    p0 = init_params(V, NL, D, seed=0)
    p1 = init_params(V, NL, D, seed=5)
    kept = {k: v.copy() for k, v in p0.items()}
    eng = Engine(p0, EngineConfig(**CFG), device="cpu")
    eng.warmup()
    progs = dict(eng._programs)
    eng.swap_weights(p1)
    assert eng._programs == progs          # the same program objects
    assert all(np.array_equal(p0[k], kept[k]) for k in p0)
    fresh = Engine(p1, EngineConfig(**CFG), device="cpu")
    assert _serve(eng, PROMPTS) == _serve(fresh, PROMPTS)
    assert {i["source"] for i in eng.warmup()} == {"memory"}


# ---------------------------------------------------------------------------
# The legacy API: Executor, Module, BucketingModule, FeedForward
# ---------------------------------------------------------------------------

def _mlp_bn(S):
    net = S.FullyConnected(data=S.Variable("data"), num_hidden=16,
                           name="fc1")
    net = S.BatchNorm(data=net, name="bn1")
    net = S.Activation(data=net, act_type="relu")
    net = S.FullyConnected(data=net, num_hidden=4, name="fc2")
    return S.SoftmaxOutput(data=net, name="softmax")


def _bound(pkg_mx, ctx, seed=1):
    ex = _mlp_bn(pkg_mx.symbol).simple_bind(ctx, data=(8, 6))
    rng = np.random.RandomState(seed)
    for n in sorted(ex.arg_dict):
        if n not in ("data", "softmax_label"):
            ex.arg_dict[n][:] = (0.3 * rng.randn(
                *ex.arg_dict[n].shape)).astype(np.float32)
    return ex


def test_executor_warmup_equals_jax():
    jex = _bound(mx, mx.cpu())
    with mxt.cpu():
        tex = _bound(mxt, mxt.cpu())
        jinfos, tinfos = jex.warmup(), tex.warmup()
        assert [i["kind"] for i in tinfos] == [i["kind"] for i in jinfos]
        assert tex.program_cache_size() == jex.program_cache_size() == 3
        rng = np.random.RandomState(0)
        for _ in range(2):
            x = rng.randn(8, 6).astype(np.float32)
            y = rng.randint(0, 4, 8).astype(np.float32)
            jo = jex.forward(is_train=True, data=x, softmax_label=y)
            to = tex.forward(is_train=True, data=x, softmax_label=y)
            jex.backward()
            tex.backward()
            np.testing.assert_allclose(to[0].asnumpy(), jo[0].asnumpy(),
                                       rtol=0, atol=HEAD_ATOL)
            for n in tex.grad_dict:
                np.testing.assert_allclose(
                    tex.grad_dict[n].asnumpy(), jex.grad_dict[n].asnumpy(),
                    rtol=1e-4, atol=1e-5, err_msg=n)
            for n in tex.aux_dict:
                np.testing.assert_allclose(
                    tex.aux_dict[n].asnumpy(), jex.aux_dict[n].asnumpy(),
                    **PARAM_TOL)
        assert tex.program_cache_size() == jex.program_cache_size() == 3


def test_executor_programs_bitwise_eager():
    def run(warm):
        with mxt.cpu():
            ex = _bound(mxt, mxt.cpu())
            if warm:
                ex.warmup()
            rng, outs = np.random.RandomState(0), []
            for _ in range(3):
                x = rng.randn(8, 6).astype(np.float32)
                y = rng.randint(0, 4, 8).astype(np.float32)
                outs.append(ex.forward(is_train=True, data=x,
                                       softmax_label=y)[0].asnumpy())
                ex.backward()
                outs += [g.asnumpy().copy() for g in ex.grad_arrays if g]
                outs += [a.asnumpy().copy() for a in ex.aux_arrays]
                outs.append(ex.forward(data=x)[0].asnumpy())
            return outs
    assert all(np.array_equal(a, b) for a, b in zip(run(False), run(True)))


def _scope(m):
    """The port's arrays go to the card outside a ``cpu()`` scope."""
    return m.cpu() if m is mxt else contextlib.nullcontext()


def _compiled_module(m, ctx):
    mod = m.mod.Module(_mlp_bn(m.symbol), context=ctx)
    mod.bind(data_shapes=[("data", (8, 6))],
             label_shapes=[("softmax_label", (8,))])
    sym = _mlp_bn(m.symbol)
    shapes, _, _ = sym.infer_shape(data=(8, 6), softmax_label=(8,))
    rng = np.random.RandomState(4)
    mod.init_params(arg_params={
        n: m.nd.array((0.3 * rng.randn(*sh)).astype(np.float32))
        for n, sh in zip(sym.list_arguments(), shapes)
        if n not in ("data", "softmax_label")})
    return mod, mod.compile()


def _module_step(m, mod, x):
    batch = m.io.DataBatch(data=[m.nd.array(x)],
                           label=[m.nd.array(np.zeros(8, np.float32))])
    mod.forward(batch, is_train=True)
    mod.backward()
    return mod.get_outputs()[0].asnumpy()


def test_module_compile_equals_jax():
    x = np.random.RandomState(0).rand(8, 6).astype(np.float32)
    jm, jinfos = _compiled_module(mx, mx.cpu())
    jout = _module_step(mx, jm, x)
    with mxt.cpu():
        tm, tinfos = _compiled_module(mxt, mxt.cpu())
        size = tm._exec_group.program_cache_size()
        tout = _module_step(mxt, tm, x)
    assert [i["kind"] for i in tinfos] == [i["kind"] for i in jinfos]
    assert all("device" in i for i in tinfos)
    assert size == jm._exec_group.program_cache_size()
    np.testing.assert_allclose(tout, jout, rtol=0, atol=HEAD_ATOL)
    # forward/backward after compile() created no program
    assert tm._exec_group.program_cache_size() == size


def _bucketing(m, ctx):
    def gen(n):
        net = m.symbol.FullyConnected(data=m.symbol.Variable("data"),
                                      num_hidden=8, name="fc")
        net = m.symbol.SoftmaxOutput(data=net, name="softmax")
        return net, ("data",), ("softmax_label",)
    bm = m.mod.BucketingModule(gen, default_bucket_key=10, context=ctx)
    bm.bind(data_shapes=[("data", (4, 10))],
            label_shapes=[("softmax_label", (4,))], for_training=False)
    bm.init_params(m.initializer.Uniform(0.1))
    infos = bm.compile(buckets=[10, 6])
    again = bm.compile(buckets=[10, 6])
    return ([(i["bucket"], i["kind"]) for i in infos],
            {i["source"] for i in again}, bm.cache_report())


def test_bucketing_compile_equals_jax():
    ji, jsrc, jrep = _bucketing(mx, mx.cpu())
    with mxt.cpu():
        ti, tsrc, trep = _bucketing(mxt, mxt.cpu())
    assert ti == ji and trep == jrep
    assert jsrc == tsrc == {"memory"}
    assert trep["programs"] == 2 and trep["buckets"] == 2


def test_feedforward_compile_equals_jax():
    with pytest.raises(MXNetError, match="needs initialized params"):
        mxt.FeedForward(_mlp_bn(mxt.symbol), ctx=mxt.cpu()).compile(
            {"data": (4, 6)})
    rng = np.random.RandomState(2)
    sym = _mlp_bn(mxt.symbol)
    shapes, _, aux_shapes = sym.infer_shape(data=(4, 6))
    arg = {n: (0.2 * rng.randn(*s)).astype(np.float32)
           for n, s in zip(sym.list_arguments(), shapes)
           if n not in ("data", "softmax_label")}
    aux = {n: np.ones(s, np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    x = rng.rand(8, 6).astype(np.float32)
    preds, kinds = [], []
    for m, ctx in ((mx, mx.cpu()), (mxt, mxt.cpu())):
        with _scope(m):
            ff = m.FeedForward(_mlp_bn(m.symbol), ctx=ctx,
                               arg_params={k: m.nd.array(v)
                                           for k, v in arg.items()},
                               aux_params={k: m.nd.array(v)
                                           for k, v in aux.items()})
            kinds.append([i["kind"] for i in ff.compile({"data": (4, 6)})])
            preds.append(ff.predict(m.io.NDArrayIter(x, batch_size=4)))
    assert kinds[0] == kinds[1] == ["fwd_False"]
    np.testing.assert_allclose(preds[1], preds[0], rtol=0, atol=HEAD_ATOL)
