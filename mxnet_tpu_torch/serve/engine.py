"""Serving engine: continuous batching over a paged KV cache.

Counterpart of ``mxnet_tpu/serve/engine.py``: ``submit`` / ``stream`` /
``result`` / ``cancel`` plus a ``step()`` loop that, every iteration,

1. evicts cancelled and timed-out requests (their KV blocks return to the
   pool at once),
2. admits queued requests into free decode slots (FIFO with an SLO-aware
   jump, :class:`~.scheduler.Scheduler`), never promising more blocks than
   the pool has,
3. prefills each admitted prompt whole, padded to a rung of the prompt
   ladder, or, with ``prefill_chunk > 0``, ingests prompts in chunks of
   that many tokens (at most one chunk per step while any request can
   decode), and
4. runs ONE decode step for the whole running batch, padded to a decode
   bucket; on CUDA the paged attention of every layer is the flash-decode
   kernel (:mod:`.flash_decode`), its fp8 instance for ``kv_quant="fp8"``
   pools.

With ``speculate=True`` a verify step replaces the decode step: a drafter
(:mod:`.speculate`, n-gram or a small model) proposes ``spec_k`` tokens per
row, one forward scores the window of the last token and the drafts over
the paged cache (:func:`~.kvcache.paged_verify_attention`, plain PyTorch,
as the JAX package's verify program is plain ``jnp``), and a replay-exact
acceptance rule emits 1 to ``spec_k + 1`` tokens per row.  The window's
K/V is written before attention reads it; the rejected tail is zeroed in
place afterwards (:func:`~.kvcache.scrub_positions`).  Greedy streams are
the non-speculative engine's token for token; sampled streams keep its
distribution, and a row with no live draft is its plain decode step.

With ``prefix_cache=True`` (chunked prefill only) full prompt blocks are
published to a content-hashed :class:`~.kvcache.PrefixIndex`; a later
request with the same prefix maps those blocks (reference-counted,
copy-on-write) and prefills only its suffix.  ``defrag()`` compacts live
blocks to the low end of the pools.

Programs: ``warmup()`` resolves one program per prompt bucket and per
decode bucket through :mod:`~mxnet_tpu_torch.compile_cache`, as the JAX
engine does; on the card each is the step's device work captured as a
CUDA graph over a static input buffer, and every later step of that kind
and bucket stages its host inputs into the buffer and replays the graph
(``aot_stats["replays"]``).  The graph ends at the logits and the greedy
result; sampled rows draw after the replay from their own generators.
Weights are copied into the captured storage by :meth:`Engine.
swap_weights`, so programs survive a hot swap; the poison step of
``serve_poison_logits`` runs eagerly on its NaN copies.  The engine
feeds the telemetry plane (:mod:`mxnet_tpu_torch.telemetry`) under the JAX
engine's metric and span names; plain counters on the engine
(``counters``) keep its per-engine tallies beside them.

Control-plane hooks, for :mod:`.router`: ``beat`` advances once per
completed step (a progress heartbeat); serve chaos points
(:mod:`mxnet_tpu_torch.chaos`) fire at exact step indices —
``serve_crash`` raises, ``serve_hang`` turns every later step into a
no-op, ``serve_poison_logits`` runs one step on NaN-filled weights, which
the finite check catches; :meth:`Engine.swap_weights` installs a
compatible parameter dict between steps.

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
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import chaos as chaos_mod
from .. import compile_cache as cc
from .. import telemetry
from ..base import MXNetError
from ..context import DeviceLike, resolve_device
from ..models.transformer import (lm_config_from_params, params_from_numpy,
                                  transformer_lm_decode,
                                  transformer_lm_prefill,
                                  transformer_lm_prefill_chunk,
                                  transformer_lm_verify)
from ..online.compat import check_compat, signature_of_params
from ..random import mix as _mix
from . import kvcache
from . import speculate as speculate_mod
from .flash_decode import flash_decode_attention
from .scheduler import (CANCELLED, FAILED, FINISHED, Request, Scheduler,
                        ServeError)

__all__ = ["EngineConfig", "Engine", "ServeError"]

_NEG = -1e30


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    return int(raw) if raw else default


def _env_float(name: str, default: Optional[float]) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    return float(raw) if raw else default


def _env_str(name: str, default: Optional[str]) -> Optional[str]:
    return os.environ.get(name, "").strip().lower() or default


# ---------------------------------------------------------------------------
# Sampling and speculative acceptance
# ---------------------------------------------------------------------------

# salts of the acceptance uniform and the residual draw: each is its own
# stream keyed by (request key, position, salt), apart from the plain draw
# at the same position, which stays untouched, so a row with no live draft
# is the plain decode step bit for bit
_SALT_ACCEPT = 0x5ACC
_SALT_RESID = 0x5E51


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _masked_scaled(logits, temp: float, topk: int):
    """The sampling distribution's logits of f32 rows ``[..., V]``: scaled
    by the temperature, all but the top ``topk`` masked when ``topk > 0``."""
    rows = logits / max(float(temp), 1e-6)
    if topk > 0:
        kth = torch.topk(rows, min(int(topk), rows.shape[-1]),
                         dim=-1).values[..., -1:]
        rows = rows.masked_fill(rows < kth, _NEG)
    return rows


def _gumbel_argmax(rows, seeds: Sequence[int]):
    """A draw from ``softmax(rows[i])`` for each row of ``rows`` [n, V] by
    the Gumbel-max trick, the noise of row ``i`` from a generator seeded
    ``seeds[i]``: one uniform draw per row, then one batched argmax."""
    u = torch.empty_like(rows)
    for i, seed in enumerate(seeds):
        torch.rand(rows.shape[-1], generator=_generator(seed, rows.device),
                   device=rows.device, out=u[i])
    return torch.argmax(rows - torch.log(-torch.log(u)), dim=-1)


def _sample_batch(logits, temps: Sequence[float], topks: Sequence[int],
                  keys: Sequence[int], positions: Sequence[int]):
    """Greedy / temperature / top-k sampling of each row of ``logits``
    [n, V].  Row ``i`` with ``temps[i] > 0`` draws from a generator seeded
    by ``(keys[i], positions[i])``: the draw is a pure function of the
    request key, its position and its logits, whatever else is in the
    batch."""
    logits = logits.float()
    out = logits.argmax(dim=-1)
    hot = [i for i, temp in enumerate(temps) if temp > 0]
    if hot:
        rows = torch.stack([_masked_scaled(logits[i], temps[i], topks[i])
                            for i in hot])
        drawn = _gumbel_argmax(rows, [_mix(keys[i], positions[i])
                                      for i in hot])
        for j, i in enumerate(hot):     # no index tensor to copy over
            out[i] = drawn[j]
    return out


def _window_out(draft, a, final):
    """``out[..., c]``: the accepted drafts below ``a``, ``final`` at ``a``,
    0 after.  ``draft`` [..., K], ``a`` and ``final`` [...]."""
    k = draft.shape[-1]
    idx = torch.arange(k + 1, device=draft.device)
    pad = torch.cat([draft, torch.zeros_like(draft[..., :1])], dim=-1)
    a1, f1 = a[..., None], final[..., None]
    return torch.where(idx == a1, f1, torch.where(idx < a1, pad, 0))


def _leading_accepts(acc):
    """Number of leading True entries along the last axis."""
    return torch.cumprod(acc.long(), dim=-1).sum(dim=-1)


def _spec_accept_row_greedy(logits, toks, live):
    """Greedy acceptance over ``logits`` [..., C, V], ``toks`` [..., C] and
    ``live`` [...] (any leading batch shape): draft ``c`` is accepted iff
    it equals ``argmax(logits[c-1])`` and ``c <= live``, and the token
    after the last accepted draft is the argmax at its row.  These are the
    integers :func:`_spec_accept_row` gives at temperature 0: the emitted
    stream is the non-speculative argmax stream.  Returns ``(out [..., C],
    n_emit [...])``."""
    greedy = logits.float().argmax(dim=-1)                  # [..., C]
    k = greedy.shape[-1] - 1
    draft = toks[..., 1:].long()
    live = torch.as_tensor(live, device=greedy.device)
    acc = ((greedy[..., :k] == draft)
           & (torch.arange(k, device=greedy.device) < live[..., None]))
    a = _leading_accepts(acc)
    final = greedy.gather(-1, a[..., None])[..., 0]
    return _window_out(draft, a, final), a + 1


def _spec_accept_row(logits, toks, live, key: int, temp: float, topk: int,
                     length: int):
    """Replay-exact acceptance for one request's verify window.

    ``logits``: [C, V] target scores (row ``c`` scores the token after
    window position ``c``); ``toks``: [C], ``toks[0]`` the current last
    token and ``toks[1:]`` the K drafts; ``live``: drafts in play (0..K,
    an int or a 0-d tensor); ``length``: cache entries before this step,
    so the token sampled from ``logits[c]`` sits at position
    ``length + 1 + c``, the position plain decode keys it by.

    Greedy (``temp <= 0``): :func:`_spec_accept_row_greedy`.  Temperature:
    draft ``x`` at position ``p`` is accepted iff ``u < p(x)``, with ``p``
    the temperature/top-k sampling distribution and ``u`` uniform from the
    generator of ``_mix(key, p, _SALT_ACCEPT)``.  A rejected draft is
    replaced by a draw from the residual, ``p`` with ``x``'s mass removed
    and renormalised (its logit masked), from ``_mix(key, p,
    _SALT_RESID)``; the emitted marginal is then exactly ``p`` for any
    deterministic drafter: ``p(x) d_x + (1 - p(x)) (p - p(x) d_x) / (1 -
    p(x)) = p``.  When every live draft is accepted, the bonus token is
    the plain sampler's draw at its position (:func:`_sample_batch`'s
    masked row and generator), so a row with ``live = 0`` is plain decode
    bit for bit, temperature included.  Every candidate is drawn on the
    device and the one at the accepted count picked there, so the row
    costs no copy to the host.

    Returns ``(out [C], n_emit)``: ``out[:n_emit]`` are the emitted tokens
    (accepted drafts, then the correction or bonus token).
    """
    logits = logits.float()
    if temp <= 0:
        return _spec_accept_row_greedy(logits, toks, live)
    dev = logits.device
    c = logits.shape[0]
    k = c - 1
    draft = toks[1:].long()
    live = torch.as_tensor(live, device=dev)
    masked = _masked_scaled(logits, temp, topk)
    probs = torch.softmax(masked, dim=-1)
    pos = [length + 1 + j for j in range(c)]
    us = torch.stack([torch.rand((), generator=_generator(
        _mix(key, p, _SALT_ACCEPT), dev), device=dev) for p in pos[:k]])
    p_draft = probs[:k].gather(1, draft[:, None])[:, 0]
    acc = (us < p_draft) & (torch.arange(k, device=dev) < live)
    a = _leading_accepts(acc)
    # every candidate in one draw: the bonus at each window row (all live
    # drafts accepted), the plain sampler's draw at its position (its
    # masked row, its generator); the residual at each drafted position (a
    # rejection), the draft's mass masked, from the salted generator
    cand = _gumbel_argmax(
        torch.cat([masked, masked[:k].scatter(1, draft[:, None], _NEG)]),
        [_mix(key, p) for p in pos]
        + [_mix(key, p, _SALT_RESID) for p in pos[:k]])
    bonus, resid = cand[:c], cand[c:]
    resid = torch.cat([resid, resid[-1:]])     # a == K only when a >= live
    final = torch.where(a >= live, bonus[a], resid[a])
    return _window_out(draft, a, final), a + 1


def _spec_accept(logits, tokens, live, keys: Sequence[int],
                 temps: Sequence[float], topks: Sequence[int],
                 lengths: Sequence[int]):
    """Batch acceptance: ``logits`` [B, C, V], ``tokens`` [B, C] and
    ``live`` [B] on the device, one host entry of ``keys``/``temps``/
    ``topks``/``lengths`` per real row.  Every row takes the greedy rule in
    one batched pass; the rows with ``temperature > 0`` (chosen on the
    host, where their temperatures are) then take the full rule.  Both
    rules give the same integers at temperature 0, so the choice cannot
    change a stream."""
    out, n_emit = _spec_accept_row_greedy(logits, tokens, live)
    for i, temp in enumerate(temps):
        if temp > 0:
            out[i], n_emit[i] = _spec_accept_row(
                logits[i], tokens[i], live[i], keys[i], temp, topks[i],
                lengths[i])
    return out, n_emit


def _first_token(last):
    """A prefill's device result from the logits row of the prompt's
    last token ([1, V]): the row, and ``[argmax, finite]`` as int32 (a
    program's outputs stay 32-bit, as the JAX engine's)."""
    lf = last.float()
    return last, torch.stack([lf.argmax(dim=-1)[0].to(torch.int32),
                              torch.isfinite(lf).all().to(torch.int32)])


def _first_token_host(last, res, temp: float, topk: int, key: int,
                      position: int) -> Tuple[int, bool]:
    """The first token (sampled from ``last`` when ``temp > 0``) and
    whether its logits were finite, in one copy to the host."""
    if temp > 0:
        res = torch.stack([_sample_batch(last, [temp], [topk], [key],
                                         [position])[0], res[1]])
    res = res.cpu()
    return int(res[0]), bool(res[1])


@dataclass(frozen=True)
class EngineConfig:
    """Static engine geometry: the fields and defaults of the JAX
    package's ``EngineConfig``.  ``heads`` must come from the caller: it
    is not recoverable from parameter shapes."""
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
    prefill_chunk: int = 0        # > 0: chunked prefill, chunk budget
    kv_quant: Optional[str] = None   # None (dtype pools) | "fp8"
    attn_impl: str = "auto"       # auto | scan | dense | flash
    speculate: bool = False       # draft-then-verify multi-token steps
    spec_k: int = 4               # drafted tokens per verify window
    spec_draft: str = "ngram"     # "ngram" (prompt lookup) | "model"
    spec_window: int = 16         # the model drafter's context window
    prefix_cache: bool = False
    prefix_cap_frac: float = 0.5
    prefix_min_blocks: int = 1

    @classmethod
    def from_env(cls, **overrides) -> "EngineConfig":
        """Defaults from the JAX package's ``MXNET_TPU_SERVE_*``
        environment variables; explicit keyword arguments win."""
        env = dict(
            block_size=_env_int("MXNET_TPU_SERVE_BLOCK_SIZE", 16),
            num_blocks=_env_int("MXNET_TPU_SERVE_BLOCKS", 128),
            max_batch=_env_int("MXNET_TPU_SERVE_MAX_BATCH", 8),
            max_queue=_env_int("MXNET_TPU_SERVE_MAX_QUEUE", 64),
            max_seq_len=_env_int("MXNET_TPU_SERVE_MAX_SEQ", 256),
            slo_ms=_env_float("MXNET_TPU_SERVE_SLO_MS", None),
            deadline_ms=_env_float("MXNET_TPU_SERVE_DEADLINE_MS", None),
            prefill_chunk=_env_int("MXNET_TPU_SERVE_PREFILL_CHUNK", 0),
            kv_quant=_env_str("MXNET_TPU_SERVE_KV_QUANT", None),
            attn_impl=_env_str("MXNET_TPU_SERVE_ATTN", "auto"),
            speculate=bool(_env_int("MXNET_TPU_SERVE_SPECULATE", 0)),
            spec_k=_env_int("MXNET_TPU_SERVE_SPEC_K", 4),
            spec_draft=_env_str("MXNET_TPU_SERVE_SPEC_DRAFT", "ngram"),
            prefix_cache=bool(_env_int("MXNET_TPU_SERVE_PREFIX_CACHE", 0)),
            prefix_cap_frac=_env_float("MXNET_TPU_SERVE_PREFIX_CAP_FRAC",
                                       0.5),
            prefix_min_blocks=_env_int("MXNET_TPU_SERVE_PREFIX_MIN_BLOCKS",
                                       1),
        )
        env.update(overrides)
        return cls(**env)

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
    ``device=None`` is the card; pass ``device="cpu"`` for the CPU.  A
    ``spec_draft="model"`` engine takes the draft model's parameter dict
    and heads (``draft_heads=None``: the target's).  ``chaos=None`` reads
    ``MXNET_TPU_CHAOS`` (its serve kinds); an empty
    :class:`~mxnet_tpu_torch.chaos.ChaosSpec` forces chaos off."""

    def __init__(self, params: Dict[str, Any], config: EngineConfig,
                 device: DeviceLike = None,
                 chaos: Optional[chaos_mod.ChaosSpec] = None,
                 draft_params: Optional[Dict[str, Any]] = None,
                 draft_heads: Optional[int] = None):
        if chaos is None:
            chaos = chaos_mod.serve_from_env()
        self.chaos = chaos if chaos else None
        self.beat = 0            # liveness: +1 per completed step
        self._hung = False       # chaos serve_hang: steps become no-ops
        self._poison_step = False
        self._poison_params = None
        self.prefill_chunk = int(config.prefill_chunk or 0)
        if self.prefill_chunk < 0:
            raise MXNetError(f"prefill_chunk must be >= 0, "
                             f"got {self.prefill_chunk}")
        if config.max_prompt_len > config.max_seq_len:
            raise MXNetError(
                f"max_prompt_len {config.max_prompt_len} exceeds "
                f"max_seq_len {config.max_seq_len}")
        self.config = config
        self.kv_quant = config.kv_quant
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
        # -- the cross-request prefix cache --
        self.prefix: Optional[kvcache.PrefixIndex] = None
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_hit_tokens = 0
        self._prefix_evictions = 0
        if config.prefix_cache:
            if not self.prefill_chunk:
                raise MXNetError(
                    "prefix_cache requires chunked prefill "
                    "(prefill_chunk > 0): cache hits skip whole chunks")
            if not (0.0 < config.prefix_cap_frac <= 1.0):
                raise MXNetError(
                    f"prefix_cap_frac must be in (0, 1], "
                    f"got {config.prefix_cap_frac}")
            if config.prefix_min_blocks < 1:
                raise MXNetError(
                    f"prefix_min_blocks must be >= 1, "
                    f"got {config.prefix_min_blocks}")
            self.prefix = kvcache.PrefixIndex(bs)
            # hits are floored to a multiple of lcm(block, chunk): a warm
            # request's remaining chunks then land on the chunk grid a
            # cold prefill uses, so its stream equals a cache-cold run's
            self._hit_quantum = (bs * self.prefill_chunk
                                 // np.gcd(bs, self.prefill_chunk))
            self.alloc.cache_cap = max(
                1, int(config.prefix_cap_frac * (config.num_blocks - 1)))
            self.alloc.cache_filter = self.prefix.contains_block

            def _on_evict(block: int) -> None:
                self.prefix.drop_block(block)
                self._prefix_evictions += 1
                telemetry.counter("serve.prefix.evictions").inc()

            self.alloc.on_evict = _on_evict
        self.kpool, self.vpool = kvcache.make_pools(
            self.num_layers, config.num_blocks, bs, self.heads,
            self.head_dim, dtype=config.dtype, quant=config.kv_quant,
            device=self.device)
        #: device bytes one cached position takes in both pools (fp8 pools
        #: take a quarter of f32's payload plus one scale per position)
        self.kv_bytes_per_token = kvcache.kv_bytes_per_token(
            self.num_layers, self.heads, self.head_dim, config.kv_quant,
            dtype=config.dtype)
        self.sched = Scheduler(config.max_batch, config.max_queue,
                               config.slo_ms, config.slo_admit_frac)
        if self.prefill_chunk:
            # one chunk shape replaces the prompt ladder: any prompt (or a
            # preempted request's re-prefill) is ceil(len / chunk) chunks
            self.prompt_buckets = tuple(
                cc.BucketPolicy.fixed(self.prefill_chunk).buckets)
        else:
            policy = cc.BucketPolicy(min_bucket=config.prompt_bucket_min,
                                     factor=config.prompt_bucket_factor,
                                     round_to=config.prompt_bucket_min)
            # the ladder covers max_seq_len, not max_prompt_len: a
            # preempted request re-prefills with prompt + generated tokens
            self.prompt_buckets = tuple(policy._ladder(config.max_seq_len))
        self.decode_buckets = config.resolved_decode_buckets()
        # captured programs by (kind, bucket), after warmup()
        self._programs: Dict[Tuple[str, int], cc.CapturedProgram] = {}
        self._bodies = {"prefill": self._body_prefill,
                        "prefill_chunk": self._body_prefill_chunk,
                        "decode": self._body_decode,
                        "verify": self._body_verify,
                        "draft": self._body_draft}
        self._graph_pool = None
        self._weights_owned = False
        #: program resolutions by source; ``replays``, and
        #: ``eager_steps`` (steps run eagerly once programs exist)
        self.aot_stats: collections.Counter = collections.Counter()
        self.requests: Dict[int, Request] = {}
        self.step_idx = 0
        self.swap_count = 0      # successful swap_weights installs
        self._chunk_ms = 0.0     # EWMA chunk-prefill latency (SLO backlog)
        #: prefills (completed), prefill_chunks, decode_steps,
        #: kernel_launches (flash-decode launches of decode steps, either
        #: instance), preemptions, tokens, nan_logits; with speculation:
        #: verify_steps, spec_drafted, spec_accepted, draft_swaps (a verify
        #: step replaces the decode step, so decode_steps and
        #: kernel_launches stay 0)
        self.counters: collections.Counter = collections.Counter()
        # -- speculative decoding --
        self.spec: Optional[speculate_mod.Drafter] = None
        self.spec_k = int(config.spec_k)
        self._decode_ms = 0.0    # EWMA verify-step latency
        self._tps = 1.0          # EWMA tokens emitted per row per step
        if config.speculate:
            if self.spec_k < 1:
                raise MXNetError(f"spec_k must be >= 1, got {self.spec_k}")
            if self.spec_k + 1 >= config.max_seq_len:
                raise MXNetError(
                    f"spec_k {self.spec_k} cannot exceed max_seq_len "
                    f"{config.max_seq_len} - 2")
            self.spec = speculate_mod.make_drafter(
                config.spec_draft, draft_params=draft_params,
                draft_heads=(draft_heads if draft_heads is not None
                             else self.heads),
                window=config.spec_window, device=self.device)
            if self.spec.kind == "model":
                self.spec.bind_runner(self._run_draft)
        telemetry.gauge("kv_bytes_per_token").set(self.kv_bytes_per_token)

    # -- weights ------------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, source: str, config: EngineConfig,
                        epoch: Optional[int] = None,
                        **kwargs) -> "Engine":
        """Build from a CheckpointManager directory, a legacy ``prefix``
        (``prefix-symbol.json`` + ``prefix-%04d.params``) or a ``.params``
        file (:func:`mxnet_tpu_torch.predictor.load_weights`); ``kwargs``
        go to the constructor (``device="cpu"``, ``chaos``, ...)."""
        from ..predictor import load_weights
        _, arg_params, _, _meta = load_weights(source, epoch)
        return cls(arg_params, config, **kwargs)

    def swap_weights(self, params_or_source: Any,
                     epoch: Optional[int] = None) -> Dict[str, Any]:
        """Install a new parameter dict into this running engine between
        steps.  Its signature (key set, shapes, dtypes) must equal the held
        weights' (:mod:`~mxnet_tpu_torch.online.compat`); an incompatible
        one raises and leaves the engine untouched — the deployment path
        rebuilds the replica instead (``Router.rolling_swap`` does).  KV
        entries survive (in-flight streams see the new weights at their
        next step; callers who need request-boundary semantics drain
        first, as ``Router.rolling_swap`` does), the prefix index is
        invalidated (its entries were computed under the old weights) and
        the NaN-poison cache of ``serve_poison_logits`` is dropped.
        ``params_or_source`` may also be anything
        :func:`~mxnet_tpu_torch.predictor.load_weights` reads.  Returns
        the compat report as a dict."""
        if isinstance(params_or_source, str):
            from ..predictor import load_weights
            _, params_or_source, _, _ = load_weights(params_or_source,
                                                     epoch)
        report = check_compat(signature_of_params(self._params),
                              signature_of_params(params_or_source))
        if not report.compatible:
            raise MXNetError(
                "swap_weights: incompatible weights — "
                f"{report.summary()} (added={report.added[:4]} "
                f"removed={report.removed[:4]} "
                f"changed={[c['name'] for c in report.changed[:4]]}); "
                "rebuild the engine (Router.rolling_swap does)")
        new = params_from_numpy(params_or_source, self.device)
        if self._weights_owned:
            # into the storage the programs captured: they stay valid
            with torch.no_grad():
                for k, v in new.items():
                    self._params[k].copy_(v)
        else:
            self._params = new
        self._poison_params = None
        if self.prefix is not None:
            # version bump: stale hashes become unreachable, and ref-0
            # cached blocks go straight back to the free list
            self.alloc.uncache(self.prefix.invalidate())
        self.swap_count += 1
        telemetry.counter("online.swaps").inc()
        return report.to_dict()

    def swap_draft_weights(self, params_or_source: Any,
                           epoch: Optional[int] = None) -> Dict[str, Any]:
        """Hot-swap the draft model's weights, independently of the
        target.  Only acceptance rates move, never the emitted greedy
        stream or the sampled streams' distribution.  Needs a ``"model"``
        drafter and a parameter dict of the held weights' signature (an
        incompatible one raises and changes nothing), or anything
        :func:`~mxnet_tpu_torch.predictor.load_weights` reads.  Returns the
        compat report as a dict."""
        if self.spec is None or self.spec.kind != "model":
            raise MXNetError(
                "swap_draft_weights: engine has no model drafter "
                "(speculate off, or spec_draft='ngram')")
        if isinstance(params_or_source, str):
            from ..predictor import load_weights
            _, params_or_source, _, _ = load_weights(params_or_source,
                                                     epoch)
        report = self.spec.swap(params_or_source)
        self.counters["draft_swaps"] += 1
        telemetry.counter("serve.spec.draft_swaps").inc()
        return report

    # -- device work --------------------------------------------------------
    #
    # Each step kind stages its host inputs (token ids, tables, lengths,
    # slot maps, the prompt length and chunk start) into ONE int32 host
    # buffer and runs its device body over that buffer on the device:
    # copied to a fresh tensor when it runs eagerly, or into the static
    # buffer of the bucket's program, which is then replayed.  The bodies
    # end at the logits and the greedy result (argmax, acceptance); rows
    # with a temperature are sampled after, with their per-row
    # generators, from the same logits, so a replayed step and an eager
    # one emit the same tokens.

    def _exec(self, kind: str, bucket: int, buf: np.ndarray):
        """Run step ``kind`` at ``bucket`` over host buffer ``buf``.
        Returns ``(body outputs, device buffer)``."""
        prog = self._programs.get((kind, bucket))
        if prog is not None and self._poison_step:
            telemetry.counter("compile_cache.uncaptured").inc()
            prog = None      # NaN copies of the weights: an eager step
        if prog is None:
            if self._programs:
                self.aot_stats["eager_steps"] += 1
            dev = torch.from_numpy(buf).to(self.device)
            return self._bodies[kind](dev, bucket), dev
        prog.stage({"buf": torch.from_numpy(buf)})
        self.aot_stats["replays"] += 1
        return prog(), prog.inputs["buf"]

    def _stage_prefill(self, toks, lb: int, blocks) -> np.ndarray:
        """tokens [lb] | table [max_blocks] | prompt length."""
        mb = self.max_blocks
        buf = np.zeros((lb + mb + 1,), np.int32)
        buf[:len(toks)] = toks
        buf[lb:lb + len(blocks)] = blocks
        buf[lb + mb] = len(toks)
        return buf

    def _body_prefill(self, dev: torch.Tensor, lb: int):
        mb = self.max_blocks
        tokens, table_t = dev[:lb].view(1, lb), dev[lb:lb + mb]
        plen = dev[lb + mb]
        logits, ks, vs = transformer_lm_prefill(self._step_params(), tokens,
                                                heads=self.heads)
        for i in range(self.num_layers):
            kvcache.write_prefill(self.kpool, i, ks[i][0], table_t, plen)
            kvcache.write_prefill(self.vpool, i, vs[i][0], table_t, plen)
        row = torch.clamp_min(plen.long() - 1, 0).reshape(1)
        return _first_token(logits[0].index_select(0, row))

    @torch.no_grad()
    def _run_prefill(self, toks: Sequence[int], lb: int, blocks: Sequence[int],
                     temp: float, topk: int, key: int) -> Tuple[int, bool]:
        """Whole-prompt prefill at bucket ``lb``: forward, scatter every
        layer's K/V into the request's blocks, sample the first token.
        Returns ``(token, logits_finite)``."""
        (last, res), _ = self._exec("prefill", lb,
                                    self._stage_prefill(toks, lb, blocks))
        return _first_token_host(last, res, temp, topk, key, len(toks))

    def _stage_prefill_chunk(self, toks, start: int, plen: int,
                             blocks) -> np.ndarray:
        """tokens [chunk] | table [max_blocks] | start | prompt length."""
        cb, mb = self.prefill_chunk, self.max_blocks
        buf = np.zeros((cb + mb + 2,), np.int32)
        buf[:len(toks)] = toks
        buf[cb:cb + len(blocks)] = blocks
        buf[cb + mb], buf[cb + mb + 1] = start, plen
        return buf

    def _body_prefill_chunk(self, dev: torch.Tensor, cb: int):
        mb = self.max_blocks
        tokens, table_t = dev[:cb].view(1, cb), dev[cb:cb + mb]
        start, plen = dev[cb + mb], dev[cb + mb + 1]
        kpool, vpool = self.kpool, self.vpool

        def attend(i, q, k, v):
            kvcache.write_prefill(kpool, i, k[0], table_t, plen, start=start)
            kvcache.write_prefill(vpool, i, v[0], table_t, plen, start=start)
            out = kvcache.paged_prefill_attention(
                q[0], kvcache.layer_view(kpool, i),
                kvcache.layer_view(vpool, i), table_t, start, plen)
            return out[None]

        logits = transformer_lm_prefill_chunk(self._step_params(), tokens,
                                              heads=self.heads, attend=attend)
        row = torch.clamp(plen.long() - 1 - start.long(), 0, cb - 1)
        return _first_token(logits[0].index_select(0, row.reshape(1)))

    @torch.no_grad()
    def _run_prefill_chunk(self, toks: Sequence[int], start: int, plen: int,
                           blocks: Sequence[int], temp: float, topk: int,
                           key: int) -> Tuple[int, bool]:
        """One prefill chunk: ``toks`` (at most ``prefill_chunk`` tokens)
        at absolute positions from ``start`` of a ``plen``-token prompt.
        Every layer writes the chunk's K/V into the request's blocks
        first, then attends causally over the whole cached prefix.  The
        first token is sampled at position ``plen`` from the row of the
        prompt's last token (read only after the final chunk).  Returns
        ``(token, logits_finite)``."""
        (last, res), _ = self._exec(
            "prefill_chunk", self.prefill_chunk,
            self._stage_prefill_chunk(toks, start, plen, blocks))
        return _first_token_host(last, res, temp, topk, key, plen)

    def _stage_decode(self, rows: Sequence[Request], bb: int):
        """tokens | lengths | slots | offsets | active (each [bb]) |
        tables [bb, max_blocks]; and the rows' sampling settings."""
        bsz = self.alloc.block_size
        mb = self.max_blocks
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
        return buf, (temps, topks, keys, positions)

    def _body_decode(self, dev: torch.Tensor, bb: int):
        mb = self.max_blocks
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

        logits = transformer_lm_decode(self._step_params(), tokens,
                                       heads=self.heads, attend=attend)
        lf = logits.float()
        return logits, torch.stack([
            lf.argmax(dim=-1).to(torch.int32),
            torch.isfinite(lf).all(dim=-1).to(torch.int32)])

    @torch.no_grad()
    def _run_decode(self, rows: Sequence[Request], bb: int):
        """One decode step for ``rows`` padded to bucket ``bb``.  Padded
        rows read and write the trash block.  Returns host arrays
        ``(tokens [bb], finite [bb])``."""
        buf, (temps, topks, keys, positions) = self._stage_decode(rows, bb)
        (logits, res), _ = self._exec("decode", bb, buf)
        if any(t > 0 for t in temps):
            res = torch.stack([_sample_batch(logits, temps, topks, keys,
                                             positions), res[1]])
        res = res.cpu().numpy()
        return res[0], res[1].astype(bool)

    def _stage_verify(self, rows: Sequence[Request], bb: int, drafts):
        """tokens | slots | offsets | write mask (each [bb, C]) | lengths |
        live | tables; and the rows' sampling settings."""
        c = self.spec_k + 1
        bsz = self.alloc.block_size
        mb = self.max_blocks
        n = 4 * bb * c
        buf = np.zeros((n + 2 * bb + bb * mb,), np.int32)
        tokens, slots, offs, wmask = buf[:n].reshape(4, bb, c)
        lengths, live = buf[n:n + bb], buf[n + bb:n + 2 * bb]
        tables = buf[n + 2 * bb:].reshape(bb, mb)
        win = np.arange(c)
        temps, topks, keys = [], [], []
        for i, req in enumerate(rows):
            tokens[i, 0] = req.tokens[-1]
            tokens[i, 1:] = drafts[i]
            tables[i, :len(req.blocks)] = req.blocks
            lengths[i] = req.cached
            live[i] = req.spec_live
            pos = req.cached + win
            slots[i] = tables[i, np.minimum(pos // bsz, mb - 1)]
            offs[i] = pos % bsz
            wmask[i] = win <= req.spec_live
            temps.append(req.temperature)
            topks.append(req.top_k)
            keys.append(req.key)
        return buf, (temps, topks, keys, lengths.copy())

    def _verify_views(self, dev: torch.Tensor, bb: int):
        c = self.spec_k + 1
        n = 4 * bb * c
        tokens_t, slot_raw, offs_t, wmask_t = dev[:n].view(4, bb, c)
        return (tokens_t, slot_raw, offs_t, wmask_t.bool(), dev[n:n + bb],
                dev[n + bb:n + 2 * bb],
                dev[n + 2 * bb:].view(bb, self.max_blocks))

    def _body_verify(self, dev: torch.Tensor, bb: int):
        (tokens_t, slot_raw, offs_t, wmask_t, lengths_t, live_t,
         tables_t) = self._verify_views(dev, bb)
        write_slots = torch.where(wmask_t, slot_raw, kvcache.TRASH_BLOCK)
        kpool, vpool = self.kpool, self.vpool

        def attend(i, q, k, v):
            kvcache.write_spec(kpool, i, k, write_slots, offs_t)
            kvcache.write_spec(vpool, i, v, write_slots, offs_t)
            return kvcache.paged_verify_attention(
                q, kvcache.layer_view(kpool, i),
                kvcache.layer_view(vpool, i), tables_t, lengths_t)

        logits = transformer_lm_verify(self._step_params(), tokens_t,
                                       heads=self.heads, attend=attend)
        out, n_emit = _spec_accept_row_greedy(logits, tokens_t, live_t)
        return logits, out.to(torch.int32), n_emit.to(torch.int32)

    @torch.no_grad()
    def _run_verify(self, rows: Sequence[Request], bb: int, drafts):
        """One speculative verify step for ``rows`` padded to bucket
        ``bb``: ``drafts`` [len(rows), K] follow each row's last token.
        Every layer writes the window's K/V (positions past a row's live
        drafts, and padded rows, go to the trash block), then attends over
        the paged cache; acceptance runs on the device (greedy for every
        row, then the full rule for rows with a temperature), then the
        rejected tail is zeroed in place.  Returns host arrays ``(out [bb,
        K+1], n_emit [bb], finite [bb])``, one copy to the host."""
        c = self.spec_k + 1
        buf, (temps, topks, keys, lengths) = self._stage_verify(
            rows, bb, drafts)
        (logits, out, n_emit), dev = self._exec("verify", bb, buf)
        (tokens_t, slot_raw, offs_t, wmask_t, _, live_t,
         _) = self._verify_views(dev, bb)
        if any(t > 0 for t in temps):
            out, n_emit = out.clone(), n_emit.clone()
            for i, temp in enumerate(temps):
                if temp > 0:
                    out[i], n_emit[i] = _spec_accept_row(
                        logits[i], tokens_t[i], live_t[i], keys[i], temp,
                        topks[i], lengths[i])
        # rollback: the cursor moves past the accepted drafts only, and
        # the rejected tail's K/V is zeroed (kept entries aim at trash)
        win_t = torch.arange(c, device=self.device)
        scrub = wmask_t & (win_t[None, :] > (n_emit - 1)[:, None])
        scrub_slots = torch.where(scrub, slot_raw, kvcache.TRASH_BLOCK)
        kvcache.scrub_positions(self.kpool, scrub_slots, offs_t)
        kvcache.scrub_positions(self.vpool, scrub_slots, offs_t)
        # the finite guard reads the window rows acceptance may read (dead
        # positions attend over unwritten entries by design)
        read = (win_t[None, :] <= live_t[:, None])[:, :, None]
        oks = (torch.isfinite(logits.float()) | ~read).flatten(1).all(dim=1)
        res = torch.cat([out, n_emit[:, None], oks[:, None].long()],
                        dim=1).cpu().numpy()
        return res[:, :c], res[:, c], res[:, c + 1].astype(bool)

    def _stage_draft(self, win: np.ndarray, lens: np.ndarray,
                     bb: int) -> np.ndarray:
        """windows [bb, W] | valid lengths [bb] (at least 1)."""
        n = win.shape[0]
        w = self.spec.window
        buf = np.ones((bb * (w + 1),), np.int32)
        buf[:bb * w] = 0
        buf[:n * w] = win.reshape(-1)
        buf[bb * w:bb * w + n] = np.maximum(lens, 1)
        return buf

    def _body_draft(self, dev: torch.Tensor, bb: int):
        w = self.spec.window
        toks, ln = dev[:bb * w].view(bb, w), dev[bb * w:]
        outs = []
        for _ in range(self.spec_k):
            logits = speculate_mod.draft_window_logits(
                self.spec.params, toks, ln, heads=self.spec.heads)
            nxt = logits.float().argmax(dim=-1).to(torch.int32)
            outs.append(nxt)
            toks = torch.cat([toks[:, 1:], nxt[:, None]], dim=1)
            ln = torch.clamp_max(ln + 1, w)
        return torch.stack(outs, dim=1)

    @torch.no_grad()
    def _run_draft(self, win: np.ndarray, lens: np.ndarray,
                   bb: Optional[int] = None) -> np.ndarray:
        """The model drafter's K-step greedy unroll over right-aligned
        windows ``win`` [n, W] with ``lens`` [n] valid tokens, padded to
        decode bucket ``bb`` (the smallest that holds ``n`` by default):
        the drafts of a row do not depend on its batch neighbours.
        Returns host drafts [n, K]."""
        n = win.shape[0]
        bb = cc.bucket_for(n, self.decode_buckets) if bb is None else bb
        out, _ = self._exec("draft", bb, self._stage_draft(win, lens, bb))
        return out.cpu().numpy()[:n]

    # -- programs -------------------------------------------------------------

    def _blank(self, kind: str, bucket: int) -> np.ndarray:
        """The host buffer of a step with no rows: every write lands in the
        trash block (a program's warm-up and capture run on it)."""
        if kind == "prefill":
            return self._stage_prefill([], bucket, [])
        if kind == "prefill_chunk":
            return self._stage_prefill_chunk([], 0, 0, [])
        if kind == "decode":
            return self._stage_decode([], bucket)[0]
        if kind == "verify":
            return self._stage_verify(
                [], bucket, np.zeros((0, self.spec_k), np.int32))[0]
        return self._stage_draft(np.zeros((0, self.spec.window), np.int32),
                                 np.zeros((0,), np.int32), bucket)

    def _fingerprint(self) -> str:
        """The served model's identity for program keys."""
        spec = self.spec.signature() if self.spec is not None else None
        return (f"transformer_lm:v{self.vocab}:l{self.num_layers}:"
                f"d{self.d_model}:h{self.heads}:bs{self.alloc.block_size}:"
                f"mb{self.max_blocks}:{self.attn_impl}:{self.kv_quant}:"
                f"{self.config.dtype}:k{self.spec_k}:{spec}")

    def _own_weights(self) -> None:
        """Give the engine storage of its own for its weights (and a model
        drafter's) before a capture: a hot swap then copies into the
        captured storage instead of rebinding it, and never writes a
        caller's arrays."""
        if not self._weights_owned:
            self._params = {k: v.clone() for k, v in self._params.items()}
            self._weights_owned = True
        if self.spec is not None and self.spec.kind == "model":
            self.spec.own_params()

    def _owned_tensors(self) -> List[torch.Tensor]:
        """The weights (a model drafter's too) and the pools: what a
        program's trace declares as its state."""
        ts = list(self._params.values())
        if self.spec is not None and self.spec.kind == "model":
            ts += list(self.spec.params.values())
        return (ts + list(kvcache._leaves(self.kpool))
                + list(kvcache._leaves(self.vpool)))

    def _ensure_program(self, kind: str, bucket: int) -> Dict[str, Any]:
        """Resolve the program of ``(kind, bucket)`` through the program
        cache and install it; returns its info (``source``, ``seconds``,
        ``digest``, ``kind``, ``bucket``)."""
        pkey = (kind, bucket)
        self._own_weights()
        blank = self._blank(kind, bucket)
        params = self.spec.params if kind == "draft" else self._params
        avals = {"params": params,
                 "pools": kvcache._leaves(self.kpool)
                 + kvcache._leaves(self.vpool),
                 "buf": torch.empty(blank.shape, dtype=torch.int32,
                                    device="meta")}
        ckey = cc.program_key(self._fingerprint(), avals, donate=(0, 1),
                              backend=cc.backend_of(self.device),
                              extra={"serve": kind, "bucket": bucket,
                                     "owner": cc.owner_token(self)})

        def build():
            if pkey in self._programs:
                return self._programs[pkey]
            static = torch.from_numpy(blank).to(self.device)
            if self._graph_pool is None and self.device.type == "cuda":
                self._graph_pool = torch.cuda.graph_pool_handle()
            body = self._bodies[kind]

            def run():
                with torch.no_grad():
                    return body(static, bucket)
            return cc.CapturedProgram(
                f"serve.{kind}.{bucket}", run, self.device,
                pool=self._graph_pool, inputs={"buf": static},
                state=self._owned_tensors).build()

        prog, info = cc.get_cache().get_or_compile(
            ckey, build, label=f"serve.{kind}.{bucket}")
        self.aot_stats[info["source"]] += 1
        self._programs[pkey] = prog
        return dict(info, kind=kind, bucket=bucket)

    def warmup(self) -> List[Dict[str, Any]]:
        """Resolve every program the engine serves with through the
        program cache: each prompt bucket (the chunk, with chunked
        prefill) and each decode bucket (the verify step, with
        speculation; and a model drafter's unroll).  On the card each is
        a captured graph (``"capture"``; a second ``warmup`` is all
        ``"memory"`` hits), built over the trash block, so live blocks
        stay untouched; afterwards every step of those kinds replays its
        bucket's program, and steady-state serving captures nothing.  On
        the CPU the programs run eagerly (``"eager"``).  Counters are not
        touched.  Returns the JAX engine's infos."""
        with telemetry.span("serve.warmup"):
            pkind = "prefill_chunk" if self.prefill_chunk else "prefill"
            infos = [self._ensure_program(pkind, lb)
                     for lb in self.prompt_buckets]
            dkind = "verify" if self.spec is not None else "decode"
            infos += [self._ensure_program(dkind, bb)
                      for bb in self.decode_buckets]
            if self.spec is not None and self.spec.kind == "model":
                infos += [self._ensure_program("draft", bb)
                          for bb in self.decode_buckets]
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
        telemetry.counter("serve.submitted").inc()
        return req.id

    def adopt(self, prompt: Sequence[int], tokens: Sequence[int], *,
              max_new_tokens: int = 32, temperature: float = 0.0,
              top_k: int = 0, slo_ms: Optional[float] = None,
              eos_id: Optional[int] = None, seed: Optional[int] = None,
              deadline_ms: Optional[float] = None,
              submit_t: Optional[float] = None) -> int:
        """Admit a request that already produced ``tokens`` on another
        engine (a router's mid-stream failover).  It re-prefills ``prompt
        + tokens`` as a preempted request does and, because draws are
        keyed by (engine seed, request seed, position), continues the
        exact stream the first engine would have produced, speculation on
        or off.  ``seed`` is mandatory: an implicit one (this engine's
        request id) could never match the original's.  ``submit_t`` keeps
        the original submit time, so SLO and deadline clocks run on."""
        prompt = [int(t) for t in prompt]
        tokens = [int(t) for t in tokens]
        if seed is None:
            raise MXNetError("adopt() needs the original request seed")
        if not prompt:
            raise MXNetError("empty prompt")
        if len(prompt) + max_new_tokens > self.config.max_seq_len:
            raise MXNetError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds max_seq_len {self.config.max_seq_len}")
        if len(tokens) >= max_new_tokens:
            raise MXNetError(
                f"nothing to adopt: {len(tokens)} tokens already meet "
                f"max_new_tokens {max_new_tokens}")
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      slo_ms=slo_ms, eos_id=eos_id)
        req.deadline_ms = (deadline_ms if deadline_ms is not None
                           else self.config.deadline_ms)
        req.tokens = list(tokens)
        req.key = _mix(self.config.seed, seed)
        self.sched.submit(req, now=submit_t)
        if tokens:
            # the first token was streamed elsewhere: no new TTFT
            req.first_token_t = req.submit_t
        self.requests[req.id] = req
        telemetry.counter("serve.adopted").inc()
        return req.id

    def cancel(self, req_id: int) -> None:
        req = self._req(req_id)
        if not req.done():
            self.sched.cancel(req)
            telemetry.counter("serve.cancelled").inc()

    def request(self, req_id: int) -> Request:
        return self._req(req_id)

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
        batched decode step.  Any exception dumps the flight recorder
        (``serve-error``) before propagating."""
        try:
            self._step_inner()
        except Exception as exc:   # noqa: BLE001 — observe, then re-raise
            telemetry.dump_flight("serve-error", extra={
                "error": repr(exc), "step": self.step_idx,
                "active": [r.id for r in self.sched.running],
                "queued": [r.id for r in self.sched.queue]})
            raise

    def _step_inner(self) -> None:
        if self._hung:
            # a wedged step: returns, makes no progress and never advances
            # `beat`; only a router's heartbeat timeout gets its requests out
            return
        self.step_idx += 1
        self._poison_step = False
        if self.chaos is not None:
            self._chaos_fire()
            if self._hung:
                return
        now = time.monotonic()
        for req in list(self.sched.running):
            if req.cancel_requested:
                self._finish(req, "cancelled", CANCELLED)
        for req in list(self.sched.running) + list(self.sched.queue):
            if (req.deadline_ms is not None
                    and (now - req.submit_t) * 1e3 > req.deadline_ms):
                telemetry.counter("serve.timeouts").inc()
                self._finish(req, "timeout", FAILED)
        with telemetry.span("serve.admit", step=self.step_idx,
                            queued=self.sched.queue_depth):
            admitted = self.sched.admit(
                self._admission_gate(), now,
                prefill_backlog_ms=self._prefill_backlog_ms(),
                decode_backlog_ms=self._decode_backlog_ms())
        if self.prefill_chunk:
            for req in admitted:
                self._prefill_begin(req)
            self._prefill_pump()
        else:
            for req in admitted:
                self._prefill(req)
        if self.sched.running:
            self._decode_step()
        self.publish_load_gauges()
        telemetry.flight_recorder().record({
            "kind": "serve", "step": self.step_idx,
            "active": self.sched.active, "queued": self.sched.queue_depth,
            "blocks_used": self.alloc.num_used})
        self.beat += 1

    def publish_load_gauges(self) -> None:
        """Refresh this engine's load gauges.  :meth:`step` calls it every
        step; a router overwrites the shared names with fleet aggregates
        every router step, so fleet readings never depend on which engine
        stepped last, or whether any did."""
        telemetry.gauge("serve.queue_depth").set(self.sched.queue_depth)
        telemetry.gauge("serve.active_slots").set(self.sched.active)
        telemetry.gauge("serve.kv_blocks_used").set(self.alloc.num_used)
        if self.prefix is not None:
            telemetry.gauge("serve.prefix.cached_frac").set(
                self.alloc.num_cached / (self.config.num_blocks - 1))

    def _chaos_fire(self) -> None:
        """Serve chaos points, fired by exact step index (over the
        engine's lifetime, so failures reproduce bit for bit)."""
        i = self.step_idx
        if self.chaos.at("serve_crash", i):
            telemetry.counter("serve.chaos_injected").inc(kind="crash")
            raise chaos_mod.ChaosError(
                "chaos: injected replica crash at serve step %d" % i)
        if self.chaos.at("serve_hang", i):
            telemetry.counter("serve.chaos_injected").inc(kind="hang")
            self._hung = True
            return
        if self.chaos.at("serve_poison_logits", i):
            telemetry.counter("serve.chaos_injected").inc(kind="poison")
            self._poison_step = True

    def _step_params(self) -> Dict[str, torch.Tensor]:
        """The weights of this step: NaN-filled copies of the floating
        point ones at a ``serve_poison_logits`` point (same shapes and
        types, so the same kernels run and the finite check must catch
        it), cached until the next swap."""
        if not self._poison_step:
            return self._params
        if self._poison_params is None:
            self._poison_params = {
                k: (torch.full_like(v, float("nan"))
                    if v.is_floating_point() else v)
                for k, v in self._params.items()}
        return self._poison_params

    # -- prefix cache -------------------------------------------------------

    def _probe(self, tokens: Sequence[int]) -> List[int]:
        """Longest usable cached prefix of ``tokens``: blocks from the
        index, floored to the hit quantum (chunk-grid alignment) and kept
        strictly below ``len(tokens)``, so at least one suffix chunk runs
        (the final chunk samples the first token)."""
        if self.prefix is None:
            return []
        blocks = self.prefix.match(tokens)
        bs = self.alloc.block_size
        hit = min(len(blocks) * bs, len(tokens) - 1)
        hit -= hit % self._hit_quantum
        nblk = hit // bs
        if nblk < self.config.prefix_min_blocks:
            return []
        return blocks[:nblk]

    def prefix_probe(self, tokens: Sequence[int]) -> int:
        """Tokens of ``tokens`` this engine could serve from its prefix
        cache right now (0 when the cache is off).  Read-only."""
        if self.prefix is None:
            return 0
        return len(self._probe([int(t) for t in tokens])) \
            * self.alloc.block_size

    def _count_prefix_hit(self, nblocks: int) -> None:
        bs = self.alloc.block_size
        self._prefix_hits += 1
        self._prefix_hit_tokens += nblocks * bs
        telemetry.counter("serve.prefix.hits").inc()
        telemetry.counter("serve.prefix.shared_blocks").inc(nblocks)
        telemetry.counter("serve.prefix.hit_tokens").inc(nblocks * bs)

    def _publish_prefix(self, req: Request) -> None:
        """Publish every newly completed full prefill block of ``req``.
        Called only after a chunk with finite logits and never on a poison
        step, so indexed blocks are clean; a full block is never written
        again (decode writes land past the prefill target)."""
        if self.prefix is None or self._poison_step:
            return
        n_full = min(req.prefilled, req.prefill_target) \
            // self.alloc.block_size
        if n_full <= req.published:
            return
        toks = req.seed_tokens[:n_full * self.alloc.block_size]
        hashes = self.prefix.chain_hashes(toks)
        for j in range(req.published, n_full):
            self.prefix.publish(hashes[j], req.blocks[j])
        req.published = n_full

    def _map_prefix_second_chance(self, req: Request) -> None:
        """Re-probe just before a request's first chunk runs: requests
        admitted in one step probed an index none of them had filled yet,
        and by now an earlier one may have published the shared prefix.
        Hit blocks replace the fresh (unwritten) leading blocks."""
        hits = self._probe(self._prefill_tokens(req))
        if not hits:
            self._prefix_misses += 1
            telemetry.counter("serve.prefix.misses").inc()
            return
        n = len(hits)
        for b in hits:
            self.alloc.addref(b, req.id)
        drop = req.blocks[:n]
        req.blocks = hits + req.blocks[n:]
        self.alloc.release(drop, req.id)
        req.prefilled = req.cached = n * self.alloc.block_size
        req.prefix_hit = n * self.alloc.block_size
        req.published = n
        self._count_prefix_hit(n)

    # -- admission and prefill ----------------------------------------------

    def _admission_gate(self):
        """``can_place`` for one admit pass: blocks promised to earlier
        candidates of the pass are reserved, so requests admitted together
        never claim more blocks than the pool has.  With the prefix cache,
        a candidate's longest cached prefix is pinned (addref) and costs
        nothing; the budget counts evictable cached blocks as free."""
        reserved = 0

        def can_place(req: Request) -> bool:
            nonlocal reserved
            toks = self._prefill_tokens(req)
            hits = self._probe(toks)
            for b in hits:
                self.alloc.addref(b, req.id)
            need = self.alloc.blocks_for_tokens(len(toks)) - len(hits)
            if reserved + need > self.alloc.num_available:
                if hits:       # roll the pins back: admission stops
                    self.alloc.release(hits, req.id)
                return False
            reserved += need
            req.prefix_blocks = hits
            return True

        return can_place

    def _resumes(self, req: Request) -> bool:
        """Whether ``req`` resumes rather than starts: a speculating
        engine re-ingests a request that already holds generated tokens
        (preempted, or adopted from another engine) up to its last token,
        draws nothing at prefill, and verifies on from that token.  Its
        next verify window then starts where the interrupted run's next
        window would have, with the same context, drafts and
        position-keyed draws, so sampled streams continue bit for bit (a
        token drawn at prefill would come from the plain sampler, where
        the interrupted run's came from acceptance).  Greedy streams are
        the argmax stream either way.  A plain engine re-ingests every
        token and draws at prefill, as the JAX engine does: its streams
        would be the same either way, but its prefill and chunk counts are
        held to the JAX engine's."""
        return self.spec is not None and bool(req.tokens)

    def _prefill_tokens(self, req: Request) -> List[int]:
        """The tokens a (re)prefill ingests: prompt and generated tokens,
        less the last one when the request resumes."""
        toks = req.seed_tokens
        return toks[:-1] if self._resumes(req) else toks

    def _prefill(self, req: Request) -> None:
        toks = self._prefill_tokens(req)
        plen = len(toks)
        req.blocks = self.alloc.alloc(self.alloc.blocks_for_tokens(plen),
                                      req.id)
        lb = cc.bucket_for(plen, self.prompt_buckets)
        t0 = time.monotonic()
        with telemetry.span("serve.prefill", req=req.id, bucket=lb,
                            prompt=plen):
            tok, ok = self._run_prefill(toks, lb, req.blocks,
                                        req.temperature, req.top_k, req.key)
        req.cached = plen
        req.prefilled = req.prefill_target = plen
        self.counters["prefills"] += 1
        telemetry.counter("serve.prefills").inc()
        telemetry.histogram("serve.prefill_ms").observe(
            (time.monotonic() - t0) * 1e3)
        if not ok:
            self._fail_nan(req)
            return
        if not self._resumes(req):
            self._append_token(req, tok)

    # -- chunked prefill ------------------------------------------------------

    def _prefill_begin(self, req: Request) -> None:
        """Admission half of chunked prefill: take the blocks the whole
        prompt needs (the gate reserved them) and arm the chunk pump; no
        device work yet.  Blocks the gate pinned from the prefix index
        lead the table and count as prefilled."""
        toks = self._prefill_tokens(req)
        req.prefill_target = len(toks)
        hits = req.prefix_blocks
        req.prefix_blocks = []
        fresh = self.alloc.alloc(
            self.alloc.blocks_for_tokens(len(toks)) - len(hits), req.id)
        req.blocks = hits + fresh
        req.prefilled = req.cached = len(hits) * self.alloc.block_size
        req.prefix_hit = req.prefilled
        req.published = len(hits)
        if hits:
            self._count_prefix_hit(len(hits))

    def _prefill_pump(self) -> None:
        """Run prefill chunks of mid-prefill requests, oldest first.
        While any request can decode, at most one chunk runs per step, so
        the stall a prefill puts into running decodes is one chunk; when
        nothing can decode yet, chunks run until one request can."""
        while True:
            pending = [r for r in self.sched.running
                       if r.prefilled < r.prefill_target]
            if not pending:
                return
            self._prefill_chunk_step(pending[0])
            if any(r.prefilled >= r.prefill_target
                   for r in self.sched.running):
                return

    def _prefill_chunk_step(self, req: Request) -> None:
        cb = self.prefill_chunk
        if self.prefix is not None and req.prefilled == 0:
            self._map_prefix_second_chance(req)
        start = req.prefilled
        plen = req.prefill_target
        t0 = time.perf_counter()
        with telemetry.span("serve.prefill", req=req.id, bucket=cb,
                            prompt=plen, chunk_start=start,
                            chunk_budget=cb):
            tok, ok = self._run_prefill_chunk(
                req.seed_tokens[start:min(start + cb, plen)], start, plen,
                req.blocks, req.temperature, req.top_k, req.key)
        ms = (time.perf_counter() - t0) * 1e3
        self._chunk_ms = (ms if self._chunk_ms == 0.0
                          else 0.8 * self._chunk_ms + 0.2 * ms)
        req.prefilled = min(start + cb, plen)
        req.cached = req.prefilled
        self.counters["prefill_chunks"] += 1
        telemetry.counter("serve.prefill_chunks").inc()
        telemetry.histogram("serve.prefill_ms").observe(ms)
        if not ok:
            # a mid-prompt NaN already reached this request's cached K/V
            self._fail_nan(req)
            return
        self._publish_prefix(req)
        if req.prefilled >= plen:
            self.counters["prefills"] += 1
            telemetry.counter("serve.prefills").inc()
            if not self._resumes(req):
                self._append_token(req, tok)

    def _prefill_backlog_ms(self) -> float:
        """Expected delay from the remaining prefill chunks of admitted
        requests, credited to queued requests' SLO clocks."""
        if not self.prefill_chunk or not self._chunk_ms:
            return 0.0
        remaining = sum(
            -(-(r.prefill_target - r.prefilled) // self.prefill_chunk)
            for r in self.sched.running
            if r.prefilled < r.prefill_target)
        return remaining * self._chunk_ms

    def _grow_blocks(self, req: Request, extra: int = 1) -> bool:
        """Ensure the request owns blocks through cache index ``cached +
        extra - 1`` (a decode step writes one entry, a verify step up to
        ``live + 1``).  On pool exhaustion, preempts the youngest-admitted
        request (blocks freed, request requeued; its stream replays
        identically).  Returns False if ``req`` itself was preempted."""
        while len(req.blocks) * self.alloc.block_size < req.cached + extra:
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
        telemetry.counter("serve.preemptions").inc()
        # drop references, don't force-free: shared prefix blocks stay for
        # their co-owners, and the victim's published blocks park in the
        # cache for its re-prefill to find
        self.alloc.release(victim.blocks, victim.id)
        victim.blocks = []
        victim.cached = 0
        victim.prefilled = 0
        victim.prefill_target = 0
        victim.prefix_blocks = []
        victim.prefix_hit = 0
        victim.published = 0
        self.sched.requeue(victim)

    def _decode_step(self) -> None:
        if self.spec is not None:
            self._verify_step()
            return
        # growth pass first: a preemption mutates sched.running, so the
        # batch roster is read only afterwards.  Mid-prefill requests hold
        # blocks for their whole prompt and have no token to feed yet:
        # they stay off the roster until the pump finishes them.
        for req in list(self.sched.running):
            if (req in self.sched.running
                    and req.prefilled >= req.prefill_target):
                self._grow_blocks(req)
        active = [r for r in self.sched.running
                  if r.prefilled >= r.prefill_target]
        if not active:
            return
        bb = cc.bucket_for(len(active), self.decode_buckets)
        fd = flash_decode_attention
        launches = fd.launches + fd.launches_fp8
        t0 = time.monotonic()
        with telemetry.span("serve.decode", step=self.step_idx, bucket=bb,
                            active=len(active)):
            toks, oks = self._run_decode(active, bb)
        step_ms = (time.monotonic() - t0) * 1e3
        self.counters["decode_steps"] += 1
        self.counters["kernel_launches"] += (fd.launches + fd.launches_fp8
                                             - launches)
        hist = telemetry.histogram("serve.token_ms")
        for i, req in enumerate(active):
            req.cached += 1
            if not oks[i]:
                self._fail_nan(req)
                continue
            hist.observe(step_ms)
            self._append_token(req, int(toks[i]))

    def _verify_step(self) -> None:
        """The speculative replacement of :meth:`_decode_step`: draft K
        tokens per row, verify them (and the bonus position) in one
        forward, emit 1 to K+1 tokens per row.

        A row's ``live`` (drafts in play) is clamped by its remaining
        token budget and, under pool pressure, falls to 0 rather than
        preempting a neighbour for speculative headroom: a live=0 row is
        the decode step's math inside the verify window, so speculation
        never changes what is emitted, only how many tokens a step
        brings."""
        k = self.spec_k
        for req in list(self.sched.running):
            if (req not in self.sched.running
                    or req.prefilled < req.prefill_target):
                continue
            live = max(min(k, req.max_new_tokens - len(req.tokens) - 1), 0)
            need = (self.alloc.blocks_for_tokens(req.cached + live + 1)
                    - len(req.blocks))
            if live > 0 and need > 0 and not self.alloc.can_alloc(need):
                live = 0      # no preemption for speculative headroom
            if not self._grow_blocks(req, extra=live + 1):
                continue
            req.spec_live = live
        active = [r for r in self.sched.running
                  if r.prefilled >= r.prefill_target]
        if not active:
            return
        bb = cc.bucket_for(len(active), self.decode_buckets)
        drafts = self.spec.propose([r.seed_tokens for r in active], k)
        # a wrong draft wastes width; an out-of-range id would be an
        # invalid embedding lookup
        drafts = np.clip(np.asarray(drafts, np.int32), 0, self.vocab - 1)
        t0 = time.perf_counter()
        with telemetry.span("serve.decode", step=self.step_idx, bucket=bb,
                            active=len(active), spec_k=k):
            out, n_emit, oks = self._run_verify(active, bb, drafts)
        step_ms = (time.perf_counter() - t0) * 1e3
        self._decode_ms = (step_ms if self._decode_ms == 0.0
                           else 0.8 * self._decode_ms + 0.2 * step_ms)
        hist = telemetry.histogram("serve.token_ms")
        drafted = sum(r.spec_live for r in active)
        accepted = emitted = 0
        for i, req in enumerate(active):
            n = int(n_emit[i])
            req.cached += n          # the cursor: accepted drafts + 1
            if not oks[i]:
                self._fail_nan(req)
                continue
            accepted += n - 1
            for j in range(n):
                hist.observe(step_ms if j == 0 else 0.0)
                emitted += 1
                self._append_token(req, int(out[i, j]))
                if req.done():
                    break
        self._tps = 0.8 * self._tps + 0.2 * (emitted / len(active))
        self.counters["verify_steps"] += 1
        self.counters["spec_drafted"] += drafted
        self.counters["spec_accepted"] += accepted
        telemetry.counter("serve.spec.steps").inc()
        if drafted:
            telemetry.counter("serve.spec.drafted").inc(drafted)
        if accepted:
            telemetry.counter("serve.spec.accepted").inc(accepted)
        if self.counters["spec_drafted"]:
            telemetry.gauge("serve.spec.accept_rate").set(
                self.counters["spec_accepted"]
                / self.counters["spec_drafted"])

    def _decode_backlog_ms(self) -> float:
        """Expected wait until a decode slot frees, credited to queued
        requests' SLO clocks when every slot is busy.  With speculation a
        step emits ``_tps`` tokens per row on average, so the soonest slot
        frees after ``remaining / _tps`` steps.  0 without speculation, a
        free slot or a verify step yet."""
        if self.spec is None or not self._decode_ms:
            return 0.0
        running = self.sched.running
        if not running or len(running) < self.sched.max_batch:
            return 0.0
        rem = min(r.max_new_tokens - len(r.tokens) for r in running)
        return (rem / max(self._tps, 1.0)) * self._decode_ms

    def _fail_nan(self, req: Request) -> None:
        """Non-finite logits: the request's cached K/V and the trash block
        may hold NaN, and masked attention lanes multiply by zero, so the
        blocks are zeroed before they return to the pool.  Blocks another
        request shares and blocks published to the prefix index are
        spared: they were published after finite chunks and never written
        again, and zeroing them would corrupt their co-owners."""
        self.counters["nan_logits"] += 1
        telemetry.counter("serve.nan_logits").inc()
        telemetry.flight_recorder().record({
            "kind": "serve.nan_logits", "req": req.id,
            "step": self.step_idx})
        scrub = [b for b in req.blocks
                 if self.alloc.refcount(b) <= 1
                 and (self.prefix is None
                      or not self.prefix.contains_block(b))]
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
            telemetry.histogram("serve.ttft_ms").observe(
                (now - req.submit_t) * 1e3)
        telemetry.counter("serve.tokens_total").inc()
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, "length")

    def _finish(self, req: Request, reason: str,
                state: str = FINISHED) -> None:
        self.sched.finish(req, reason, state)
        if req.blocks:
            # a reference drop: shared prefix blocks stay for their
            # co-owners, published blocks park in the LRU cache
            self.alloc.release(req.blocks, req.id)
            req.blocks = []
        if req.prefix_blocks:
            # pinned at admission, never consumed by _prefill_begin
            self.alloc.release(req.prefix_blocks, req.id)
            req.prefix_blocks = []
        telemetry.counter("serve.evictions").inc(reason=reason)

    # -- maintenance and introspection ----------------------------------------

    def defrag(self) -> int:
        """Compact live KV blocks to the low end of the pools (K and V
        move together, tables and the prefix index are rewritten).
        Returns the number of relocated blocks; outputs are bitwise
        unaffected."""
        mapping = self.alloc.defrag()
        if mapping:
            kvcache.compact_pool(self.kpool, mapping)
            kvcache.compact_pool(self.vpool, mapping)
            for req in self.sched.running:
                req.blocks = [mapping.get(b, b) for b in req.blocks]
            if self.prefix is not None:
                self.prefix.remap(mapping)
        return len(mapping)

    def check_tables(self) -> None:
        """Allocator and table integrity audit (raises on a violation)."""
        self.alloc.check({r.id: r.blocks for r in self.sched.running
                          if r.blocks})

    def stats(self) -> Dict[str, Any]:
        hits, misses = self._prefix_hits, self._prefix_misses
        drafted = self.counters["spec_drafted"]
        accepted = self.counters["spec_accepted"]
        return {
            "blocks_used": self.alloc.num_used,
            "blocks_free": self.alloc.num_free,
            "active": self.sched.active,
            "queued": self.sched.queue_depth,
            "steps": self.step_idx,
            "beat": self.beat,
            "weight_swaps": self.swap_count,
            "hung": self._hung,
            "chaos": bool(self.chaos),
            "prompt_buckets": list(self.prompt_buckets),
            "decode_buckets": list(self.decode_buckets),
            "prefill_chunk": self.prefill_chunk,
            "kv_quant": self.kv_quant,
            "attn_impl": self.attn_impl,
            "prefix": (None if self.prefix is None else {
                "entries": len(self.prefix),
                "version": self.prefix.version,
                "cached_blocks": self.alloc.num_cached,
                "hits": hits,
                "misses": misses,
                "hit_tokens": self._prefix_hit_tokens,
                "evictions": self._prefix_evictions,
                "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
            }),
            # drafted, accepted and draft swaps since the counters were last
            # cleared
            "speculate": (None if self.spec is None else {
                "draft": self.spec.kind,
                "k": self.spec_k,
                "drafted": drafted,
                "accepted": accepted,
                "accept_rate": accepted / drafted if drafted else 0.0,
                "tokens_per_step": self._tps,
                "draft_swaps": self.counters["draft_swaps"],
            }),
        }
