"""Serving engine: continuous batching over a paged KV cache.

Counterpart of ``mxnet_tpu/serve/engine.py``: ``submit`` / ``stream`` /
``result`` / ``cancel`` plus a ``step()`` loop that, every iteration,

1. evicts cancelled and timed-out requests (their KV blocks return to the
   pool at once),
2. admits queued requests into free decode slots (FIFO with an SLO-aware
   jump, :class:`~.scheduler.Scheduler`), never promising more blocks than
   the pool has,
3. prefills each admitted prompt whole, padded to a rung of the prompt
   ladder, and
4. runs ONE decode step for the whole running batch, padded to a decode
   bucket; on CUDA the paged attention of every layer is the flash-decode
   kernel (:mod:`.flash_decode`).

PyTorch runs eagerly, so there are no programs to compile: ``warmup()``
builds the kernel library and runs each prompt and decode bucket once so
that first-use costs fall outside timed work.  Plain counters on the
engine (``counters``) take the place of the JAX package's telemetry.

Determinism: decode batches always have a bucket's shape (default one
bucket at ``max_batch``) and rows are independent, so a request decodes
the same tokens alone or inside a full batch.  Temperature/top-k sampling
draws from a ``torch.Generator`` seeded by (engine seed, request seed,
position), so sampled streams also replay identically across batch
composition and preemption.  They do not match the JAX package's PRNG
bits; greedy streams match its engine token for token.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import compile_cache as cc
from ..base import MXNetError, not_ported
from ..context import DeviceLike, resolve_device
from ..models.transformer import (lm_config_from_params, params_from_numpy,
                                  transformer_lm_decode,
                                  transformer_lm_prefill)
from . import kvcache
from .flash_decode import flash_decode_attention
from .scheduler import (CANCELLED, FAILED, FINISHED, Request, Scheduler,
                        ServeError)

__all__ = ["EngineConfig", "Engine", "ServeError"]

_NEG = -1e30
_MASK64 = (1 << 64) - 1


def _mix(*vals: int) -> int:
    """splitmix64 chained over integers: the 64-bit seed of the sampling
    generator for (engine seed, request seed, position)."""
    h = 0
    for v in vals:
        z = ((h ^ (int(v) & _MASK64)) + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        h = z ^ (z >> 31)
    return h


@dataclass(frozen=True)
class EngineConfig:
    """Static engine geometry: the fields and defaults of the JAX
    package's ``EngineConfig``.  ``heads`` must come from the caller: it
    is not recoverable from parameter shapes.  Options of later slices
    (``prefill_chunk > 0``, ``kv_quant``, ``speculate``,
    ``prefix_cache``) raise at engine construction."""
    heads: int = 4
    block_size: int = 16          # kv entries per pool block
    num_blocks: int = 128         # physical pool blocks (slot 0 = trash)
    max_batch: int = 8            # decode slots
    max_queue: int = 64           # bounded wait queue
    max_prompt_len: int = 128     # top rung of the prefill ladder
    max_seq_len: int = 256        # prompt + generated, per request
    decode_buckets: Optional[Tuple[int, ...]] = None  # None -> (max_batch,)
    prompt_bucket_min: int = 16
    prompt_bucket_factor: float = 2.0
    slo_ms: Optional[float] = None       # default per-request SLO
    slo_admit_frac: float = 0.5
    deadline_ms: Optional[float] = None  # default per-request hard wall
    seed: int = 0
    dtype: Any = torch.float32           # KV pool dtype
    prefill_chunk: int = 0
    kv_quant: Optional[str] = None
    attn_impl: str = "auto"       # auto | scan | dense | flash
    speculate: bool = False
    spec_k: int = 4
    spec_draft: str = "ngram"
    spec_window: int = 16
    prefix_cache: bool = False
    prefix_cap_frac: float = 0.5
    prefix_min_blocks: int = 1

    def resolved_decode_buckets(self) -> Tuple[int, ...]:
        if self.decode_buckets:
            bs = tuple(sorted(set(int(b) for b in self.decode_buckets)))
            if bs[-1] < self.max_batch:
                raise MXNetError(
                    f"decode_buckets {bs} cannot cover max_batch "
                    f"{self.max_batch}")
            return bs
        return (self.max_batch,)

    def resolved_attn_impl(self, device: torch.device) -> str:
        """Decode attention strategy.  ``"auto"`` is the flash-decode
        kernel on CUDA and the one-shot gather (``"dense"``) on the CPU."""
        impl = self.attn_impl
        if impl == "auto":
            return "flash" if device.type == "cuda" else "dense"
        if impl not in ("scan", "dense", "flash"):
            raise MXNetError(f"attn_impl {impl!r}: expected 'auto', 'scan', "
                             "'dense' or 'flash'")
        return impl


class Engine:
    """Continuous-batching autoregressive server for ``transformer_lm``
    parameter dicts (numpy arrays or tensors, the JAX package's names).
    ``device=None`` is the card; pass ``device="cpu"`` for the CPU."""

    def __init__(self, params: Dict[str, Any], config: EngineConfig,
                 device: DeviceLike = None, chaos: Any = None):
        if chaos is not None:
            raise not_ported("serve chaos injection")
        if config.prefill_chunk < 0:
            raise MXNetError(f"prefill_chunk must be >= 0, "
                             f"got {config.prefill_chunk}")
        for on, what in ((config.prefill_chunk > 0,
                          "chunked prefill (prefill_chunk > 0)"),
                         (config.kv_quant is not None,
                          f"kv_quant={config.kv_quant!r}"),
                         (config.speculate, "speculative decoding"),
                         (config.prefix_cache, "the prefix cache")):
            if on:
                raise not_ported(what)
        if config.max_prompt_len > config.max_seq_len:
            raise MXNetError(
                f"max_prompt_len {config.max_prompt_len} exceeds "
                f"max_seq_len {config.max_seq_len}")
        self.config = config
        self.device = resolve_device(device)
        self._params = params_from_numpy(params, self.device)
        self.vocab, self.num_layers, self.d_model = (
            lm_config_from_params(self._params))
        self.heads = int(config.heads)
        if self.d_model % self.heads:
            raise MXNetError(f"d_model {self.d_model} not divisible by "
                             f"heads {self.heads}")
        self.head_dim = self.d_model // self.heads
        bs = config.block_size
        self.max_blocks = -(-config.max_seq_len // bs)
        self.attn_impl = config.resolved_attn_impl(self.device)
        self.alloc = kvcache.BlockAllocator(config.num_blocks, bs)
        self.kpool, self.vpool = kvcache.make_pools(
            self.num_layers, config.num_blocks, bs, self.heads,
            self.head_dim, dtype=config.dtype, device=self.device)
        self.sched = Scheduler(config.max_batch, config.max_queue,
                               config.slo_ms, config.slo_admit_frac)
        policy = cc.BucketPolicy(min_bucket=config.prompt_bucket_min,
                                 factor=config.prompt_bucket_factor,
                                 round_to=config.prompt_bucket_min)
        # the ladder covers max_seq_len, not max_prompt_len: a preempted
        # request re-prefills with prompt + already-generated tokens
        self.prompt_buckets = tuple(policy._ladder(config.max_seq_len))
        self.decode_buckets = config.resolved_decode_buckets()
        self.requests: Dict[int, Request] = {}
        self.step_idx = 0
        #: prefills, decode_steps, kernel_launches (flash-decode launches
        #: of decode steps), preemptions, tokens, nan_logits
        self.counters: collections.Counter = collections.Counter()

    # -- unported entry points ---------------------------------------------

    @classmethod
    def from_checkpoint(cls, *args, **kwargs) -> "Engine":
        raise not_ported("Engine.from_checkpoint")

    def swap_weights(self, *args, **kwargs):
        raise not_ported("Engine.swap_weights")

    def adopt(self, *args, **kwargs) -> int:
        raise not_ported("Engine.adopt (router failover)")

    def defrag(self) -> int:
        raise not_ported("Engine.defrag")

    # -- device work --------------------------------------------------------

    def _sample(self, logits, temps: Sequence[float], topks: Sequence[int],
                keys: Sequence[int], positions: Sequence[int]):
        """Greedy / temperature / top-k sampling of each row of ``logits``
        [n, V].  Row ``i`` with ``temps[i] > 0`` draws by the Gumbel-max
        trick from a generator seeded by ``(keys[i], positions[i])``: the
        draw is a pure function of the request key, its position and its
        logits, whatever else is in the batch."""
        logits = logits.float()
        out = logits.argmax(dim=-1)
        vocab = logits.shape[-1]
        for i, temp in enumerate(temps):
            if temp <= 0:
                continue
            row = logits[i] / max(float(temp), 1e-6)
            if topks[i] > 0:
                kth = torch.topk(row, min(int(topks[i]), vocab)).values[-1]
                row = row.masked_fill(row < kth, _NEG)
            gen = torch.Generator(device=row.device)
            gen.manual_seed(_mix(keys[i], positions[i]))
            u = torch.rand(row.shape, generator=gen, device=row.device)
            out[i] = torch.argmax(row - torch.log(-torch.log(u)))
        return out

    @torch.no_grad()
    def _run_prefill(self, toks: Sequence[int], lb: int, blocks: Sequence[int],
                     temp: float, topk: int, key: int) -> Tuple[int, bool]:
        """Whole-prompt prefill at bucket ``lb``: forward, scatter every
        layer's K/V into the request's blocks, sample the first token.
        Returns ``(token, logits_finite)``."""
        plen = len(toks)
        padded = np.zeros((1, lb), np.int32)
        padded[0, :plen] = toks
        table_row = np.zeros((self.max_blocks,), np.int32)
        table_row[:len(blocks)] = blocks
        tokens = torch.from_numpy(padded).to(self.device)
        table_t = torch.from_numpy(table_row).to(self.device)
        logits, ks, vs = transformer_lm_prefill(self._params, tokens,
                                                heads=self.heads)
        for i in range(self.num_layers):
            kvcache.write_prefill(self.kpool, i, ks[i][0], table_t, plen)
            kvcache.write_prefill(self.vpool, i, vs[i][0], table_t, plen)
        last = logits[0, plen - 1]
        tok = self._sample(last[None], [temp], [topk], [key], [plen])[0]
        ok = torch.isfinite(last.float()).all()
        res = torch.stack([tok, ok.long()]).cpu()
        return int(res[0]), bool(res[1])

    @torch.no_grad()
    def _run_decode(self, rows: Sequence[Request], bb: int):
        """One decode step for ``rows`` padded to bucket ``bb``.  Padded
        rows read and write the trash block.  Returns host arrays
        ``(tokens [bb], finite [bb])``."""
        bsz = self.alloc.block_size
        mb = self.max_blocks
        # one host buffer, one copy to the device:
        # tokens | lengths | slots | offsets | active | tables
        buf = np.zeros((5 * bb + bb * mb,), np.int32)
        tables = buf[5 * bb:].reshape(bb, mb)
        temps, topks, keys, positions = [], [], [], []
        for i, req in enumerate(rows):
            buf[i] = req.tokens[-1]
            buf[bb + i] = req.cached
            buf[2 * bb + i] = req.blocks[req.cached // bsz]
            buf[3 * bb + i] = req.cached % bsz
            buf[4 * bb + i] = 1
            tables[i, :len(req.blocks)] = req.blocks
            temps.append(req.temperature)
            topks.append(req.top_k)
            keys.append(req.key)
            positions.append(req.cached + 1)
        dev = torch.from_numpy(buf).to(self.device)
        tokens, lengths, slots, offsets, active = (
            dev[j * bb:(j + 1) * bb] for j in range(5))
        active = active.bool()
        tables_t = dev[5 * bb:].view(bb, mb)
        lens1 = lengths + 1
        kpool, vpool, impl = self.kpool, self.vpool, self.attn_impl

        def attend(i, q, k, v):
            kvcache.write_decode(kpool, i, k, slots, offsets, active)
            kvcache.write_decode(vpool, i, v, slots, offsets, active)
            return kvcache.paged_attention(
                q, kvcache.layer_view(kpool, i),
                kvcache.layer_view(vpool, i), tables_t, lens1, impl=impl)

        logits = transformer_lm_decode(self._params, tokens, heads=self.heads,
                                       attend=attend)
        toks = self._sample(logits, temps, topks, keys, positions)
        oks = torch.isfinite(logits.float()).all(dim=-1)
        res = torch.stack([toks, oks.long()]).cpu().numpy()
        return res[0], res[1].astype(bool)

    def warmup(self) -> List[Dict[str, Any]]:
        """Build the kernel library (flash on CUDA), then run every prompt
        bucket and every decode bucket once against the trash block, so
        first-use costs stay out of timed serving.  Counters are not
        touched.  Returns ``[{"kind", "bucket", "ms"}, ...]``."""
        if self.attn_impl == "flash" and self.device.type == "cuda":
            from .flash_decode import _lib
            _lib()
        infos = []
        for lb in self.prompt_buckets:
            t0 = time.perf_counter()
            self._run_prefill([0], lb, [], 0.0, 0, 0)
            infos.append({"kind": "prefill", "bucket": lb,
                          "ms": (time.perf_counter() - t0) * 1e3})
        for bb in self.decode_buckets:
            t0 = time.perf_counter()
            self._run_decode([], bb)
            infos.append({"kind": "decode", "bucket": bb,
                          "ms": (time.perf_counter() - t0) * 1e3})
        return infos

    # -- submit / stream / cancel -------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0,
               slo_ms: Optional[float] = None,
               eos_id: Optional[int] = None,
               seed: Optional[int] = None,
               deadline_ms: Optional[float] = None) -> int:
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise MXNetError("empty prompt")
        if len(prompt) > self.config.max_prompt_len:
            raise MXNetError(
                f"prompt length {len(prompt)} exceeds max_prompt_len "
                f"{self.config.max_prompt_len}")
        if len(prompt) + max_new_tokens > self.config.max_seq_len:
            raise MXNetError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds max_seq_len {self.config.max_seq_len}")
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      slo_ms=slo_ms, eos_id=eos_id)
        req.deadline_ms = (deadline_ms if deadline_ms is not None
                           else self.config.deadline_ms)
        # (engine seed, request seed): an explicit `seed` replays the same
        # stream in any engine of the port, whatever the admission order
        req.key = _mix(self.config.seed, req.id if seed is None else seed)
        self.sched.submit(req)
        self.requests[req.id] = req
        return req.id

    def cancel(self, req_id: int) -> None:
        req = self._req(req_id)
        if not req.done():
            self.sched.cancel(req)

    def _req(self, req_id: int) -> Request:
        try:
            return self.requests[req_id]
        except KeyError:
            raise MXNetError(f"unknown request id {req_id}")

    def stream(self, req_id: int):
        """Generator of token ids as they are produced; drives the engine
        loop while the request is live.  A failed request raises
        :class:`~.scheduler.ServeError` after the tokens produced so far."""
        req = self._req(req_id)
        cursor = 0
        while True:
            while cursor < len(req.tokens):
                yield req.tokens[cursor]
                cursor += 1
            if req.done():
                if req.state == FAILED:
                    raise ServeError(req.finish_reason or "error", req_id)
                return
            self.step()

    def result(self, req_id: int) -> List[int]:
        """Run the engine until the request completes; returns its tokens.
        Raises :class:`~.scheduler.ServeError` if it failed."""
        req = self._req(req_id)
        guard = 0
        while not req.done():
            self.step()
            guard += 1
            if guard > 10 * self.config.max_seq_len + 100:
                raise MXNetError(f"request {req_id} failed to converge")
        if req.state == FAILED:
            raise ServeError(req.finish_reason or "error", req_id)
        return list(req.tokens)

    def run(self, max_steps: int = 100000) -> None:
        """Drive the loop until every submitted request completes."""
        for _ in range(max_steps):
            if self.sched.idle():
                return
            self.step()
        raise MXNetError(f"engine still busy after {max_steps} steps")

    # -- the step loop -------------------------------------------------------

    def step(self) -> None:
        """One continuous-batching iteration: evict, admit + prefill, one
        batched decode step."""
        self.step_idx += 1
        now = time.monotonic()
        for req in list(self.sched.running):
            if req.cancel_requested:
                self._finish(req, "cancelled", CANCELLED)
        for req in list(self.sched.running) + list(self.sched.queue):
            if (req.deadline_ms is not None
                    and (now - req.submit_t) * 1e3 > req.deadline_ms):
                self._finish(req, "timeout", FAILED)
        for req in self.sched.admit(self._admission_gate(), now):
            self._prefill(req)
        if self.sched.running:
            self._decode_step()

    def _admission_gate(self):
        """``can_place`` for one admit pass: blocks promised to earlier
        candidates of the pass are reserved, so requests admitted together
        never claim more blocks than the pool has."""
        reserved = 0

        def can_place(req: Request) -> bool:
            nonlocal reserved
            need = self.alloc.blocks_for_tokens(len(req.seed_tokens))
            if reserved + need > self.alloc.num_available:
                return False
            reserved += need
            return True

        return can_place

    def _prefill(self, req: Request) -> None:
        toks = req.seed_tokens
        plen = len(toks)
        req.blocks = self.alloc.alloc(self.alloc.blocks_for_tokens(plen),
                                      req.id)
        lb = cc.bucket_for(plen, self.prompt_buckets)
        tok, ok = self._run_prefill(toks, lb, req.blocks, req.temperature,
                                    req.top_k, req.key)
        req.cached = plen
        req.prefilled = req.prefill_target = plen
        self.counters["prefills"] += 1
        if not ok:
            self._fail_nan(req)
            return
        self._append_token(req, tok)

    def _grow_blocks(self, req: Request) -> bool:
        """Ensure the request owns a block for cache index ``cached``.  On
        pool exhaustion, preempts the youngest-admitted request (blocks
        freed, request requeued; its stream replays identically).  Returns
        False if ``req`` itself was preempted."""
        while len(req.blocks) * self.alloc.block_size < req.cached + 1:
            if self.alloc.can_alloc(1):
                req.blocks += self.alloc.alloc(1, req.id)
                continue
            victim = max(self.sched.running,
                         key=lambda r: (r.admit_t or 0.0, r.id))
            self._preempt(victim)
            if victim is req:
                return False
        return True

    def _preempt(self, victim: Request) -> None:
        self.counters["preemptions"] += 1
        self.alloc.release(victim.blocks, victim.id)
        victim.blocks = []
        victim.cached = 0
        victim.prefilled = 0
        victim.prefill_target = 0
        self.sched.requeue(victim)

    def _decode_step(self) -> None:
        # growth pass first: a preemption mutates sched.running, so the
        # batch roster is read only afterwards
        for req in list(self.sched.running):
            if req in self.sched.running:
                self._grow_blocks(req)
        active = list(self.sched.running)
        if not active:
            return
        bb = cc.bucket_for(len(active), self.decode_buckets)
        launches = flash_decode_attention.launches
        toks, oks = self._run_decode(active, bb)
        self.counters["decode_steps"] += 1
        self.counters["kernel_launches"] += (flash_decode_attention.launches
                                             - launches)
        for i, req in enumerate(active):
            req.cached += 1
            if not oks[i]:
                self._fail_nan(req)
                continue
            self._append_token(req, int(toks[i]))

    def _fail_nan(self, req: Request) -> None:
        """Non-finite logits: the request's cached K/V and the trash block
        may hold NaN, and masked attention lanes multiply by zero, so the
        blocks are zeroed before they return to the pool."""
        self.counters["nan_logits"] += 1
        scrub = [b for b in req.blocks if self.alloc.refcount(b) <= 1]
        scrub.append(kvcache.TRASH_BLOCK)
        kvcache.scrub_blocks(self.kpool, scrub)
        kvcache.scrub_blocks(self.vpool, scrub)
        self._finish(req, "error", FAILED)

    def _append_token(self, req: Request, tok: int) -> None:
        now = time.monotonic()
        req.tokens.append(tok)
        req.token_times.append(now)
        self.counters["tokens"] += 1
        if req.first_token_t is None:
            req.first_token_t = now
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, "length")

    def _finish(self, req: Request, reason: str,
                state: str = FINISHED) -> None:
        self.sched.finish(req, reason, state)
        if req.blocks:
            self.alloc.release(req.blocks, req.id)
            req.blocks = []
