"""Draft sources for speculative decoding.

Counterpart of ``mxnet_tpu/serve/speculate.py``.  A cheap **drafter**
proposes K continuation tokens per request, the target model scores all K
in one verify forward over the paged cache
(:func:`~mxnet_tpu_torch.models.transformer.transformer_lm_verify`), and
the engine's acceptance rule keeps the emitted stream equal to the
non-speculative engine's (greedy) or distributed as its sampler's
(temperature).  A wrong draft costs verify width, never wrong output.

* :class:`NGramDrafter` — prompt lookup: propose what followed the
  longest earlier match of the context's suffix.  Host only, no weights.
* :class:`ModelDrafter` — a small ``transformer_lm`` whose weights are
  tensors on the engine's device.  The engine runs its K-step greedy
  unroll of :func:`draft_window_logits` over a right-aligned context
  window, padded to the decode bucket, and binds that runner here.
  Compatible weights swap in place (:meth:`ModelDrafter.swap`).

Nothing here touches the KV pools or the sampling generators.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..base import MXNetError
from ..context import DeviceLike, resolve_device
from ..models.transformer import (_block_step, _embed, _lm_head,
                                  lm_config_from_params, params_from_numpy)
from ..online.compat import check_compat, signature_of_params
from ..parallel.ring_attention import NEG_INF

__all__ = ["Drafter", "NGramDrafter", "ModelDrafter", "make_drafter",
           "DRAFT_KINDS", "draft_window_logits"]

#: recognised ``spec_draft`` values
DRAFT_KINDS = ("ngram", "model")


class Drafter:
    """Interface of every draft source.

    ``propose`` maps N request contexts (prompt + generated tokens, as
    int lists) to an ``[N, k]`` int32 array of drafted continuations.  It
    must be deterministic in the contexts: a preempted or adopted request
    re-proposes the same drafts, which the temperature path's replay
    relies on.
    """

    kind: str = "?"

    def propose(self, contexts: Sequence[Sequence[int]],
                k: int) -> np.ndarray:
        raise NotImplementedError

    def swap(self, params: Dict[str, Any]) -> Dict[str, Any]:
        raise MXNetError(
            f"{self.kind!r} drafter has no weights to swap — only the "
            "'model' drafter deploys through rolling_swap(target='draft')")

    def signature(self) -> str:
        """Geometry string of the drafter (the JAX package folds it into
        its program fingerprint)."""
        return self.kind


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: longest-suffix n-gram match over the
    request's own context.

    For n from ``max_n`` down to 1, find the most recent earlier
    occurrence of the context's length-n suffix and propose the tokens
    that followed it.  A match ``p`` positions back means the stream is
    locally period-p, so a continuation that runs past the context's end
    extends cyclically (``ctx[-p + (i % p)]``).  No match at any n repeats
    the last token.
    """

    kind = "ngram"

    def __init__(self, max_n: int = 3):
        if max_n < 1:
            raise MXNetError(f"NGramDrafter max_n must be >= 1, got {max_n}")
        self.max_n = int(max_n)

    def _draft_one(self, ctx: Sequence[int], k: int) -> List[int]:
        ctx = list(ctx)
        m = len(ctx)
        for n in range(min(self.max_n, m - 1), 0, -1):
            suffix = ctx[-n:]
            for j in range(m - n - 1, -1, -1):
                if ctx[j:j + n] == suffix:
                    p = m - n - j
                    return [ctx[m - p + (i % p)] for i in range(k)]
        return [ctx[-1]] * k

    def propose(self, contexts: Sequence[Sequence[int]],
                k: int) -> np.ndarray:
        return np.asarray([self._draft_one(c, k) for c in contexts],
                          np.int32).reshape(len(contexts), k)


def draft_window_logits(params, tokens, ctx_len, *, heads):
    """Last-position logits of a small transformer_lm over a right-aligned
    context window: the one forward the engine's draft step unrolls K
    times.

    ``tokens``: [B, W] ids, right-aligned (left entries pad a context
    shorter than W); ``ctx_len``: [B] valid tokens per row (>= 1).  A left
    pad is never a valid key, so the result is the forward over the
    unpadded context.  Returns [B, V] logits of the token after position
    W-1, the row's latest real token.
    """
    vocab, num_layers, d = lm_config_from_params(params)
    if d % heads:
        raise MXNetError(f"draft d_model {d} not divisible by heads {heads}")
    hd = d // heads
    b, w = tokens.shape
    scale = 1.0 / np.sqrt(hd)
    idx = torch.arange(w, device=tokens.device)
    # key j of row b is valid iff it lies in the context and is causally
    # visible: j >= W - ctx_len[b] and j <= the query position
    valid_k = idx[None, :] >= (w - ctx_len.long())[:, None]     # [B, W]
    causal = idx[:, None] >= idx[None, :]                        # [Wq, Wk]
    mask = valid_k[:, None, None, :] & causal[None, None, :, :]
    h = _embed(params, tokens)

    def attend(q, k, v):
        q, k, v = (t.reshape(b, w, heads, hd) for t in (q, k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        s = s.masked_fill(~mask, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None]).masked_fill(~mask, 0.0)
        l = torch.clamp_min(p.sum(dim=-1), 1e-30)
        out = torch.einsum("bhqk,bkhd->bqhd", p / l[..., None],
                           v.float()).to(q.dtype)
        return out.reshape(b, w, d)

    for i in range(num_layers):
        h = _block_step(params, i, h, attend)
    # the final norm and the head act per position: only the last is read
    return _lm_head(params, h[:, -1])


class ModelDrafter(Drafter):
    """A small ``transformer_lm`` as the draft source.

    Holds its parameter dict as tensors on ``device`` (numpy arrays,
    tensors or the port's NDArrays are accepted) and its heads and window.
    The engine binds the runner of its K-step greedy unroll
    (``bind_runner``).  Drafting is greedy: drafts are proposals, and the
    verify step's acceptance rule owns the output distribution.
    """

    kind = "model"

    def __init__(self, params: Dict[str, Any], *, heads: int,
                 window: int = 16, device: DeviceLike = None):
        if window < 1:
            raise MXNetError(f"ModelDrafter window must be >= 1, "
                             f"got {window}")
        self.device = resolve_device(device)
        self.params = params_from_numpy(params, self.device)
        self.heads = int(heads)
        self.window = int(window)
        self.vocab, self.num_layers, self.d_model = (
            lm_config_from_params(self.params))
        if self.d_model % self.heads:
            raise MXNetError(f"draft d_model {self.d_model} not divisible "
                             f"by heads {self.heads}")
        self._runner = None     # engine-bound: (window, ctx_len) -> [N, k]
        self._owned = False     # params in storage of its own

    def signature(self) -> str:
        return (f"model:{self.vocab}:{self.num_layers}:{self.d_model}:"
                f"{self.heads}:w{self.window}")

    def bind_runner(self, runner) -> None:
        self._runner = runner

    def windows(self, contexts: Sequence[Sequence[int]]):
        """Right-align each context into a [N, W] window and [N] valid
        lengths (the draft step's operands)."""
        w = self.window
        out = np.zeros((len(contexts), w), np.int32)
        lens = np.zeros((len(contexts),), np.int32)
        for i, ctx in enumerate(contexts):
            tail = list(ctx)[-w:]
            out[i, w - len(tail):] = tail
            lens[i] = len(tail)
        return out, lens

    def propose(self, contexts: Sequence[Sequence[int]],
                k: int) -> np.ndarray:
        if self._runner is None:
            raise MXNetError("ModelDrafter has no bound draft runner — "
                             "construct the engine with draft_params")
        win, lens = self.windows(contexts)
        return np.asarray(self._runner(win, lens), np.int32)

    def swap(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Install new draft weights.  The new dict's signature (as
        given: names, shapes, dtypes) must equal the held weights';
        otherwise this raises and nothing changes."""
        report = check_compat(signature_of_params(self.params),
                              signature_of_params(params))
        if not report.compatible:
            raise MXNetError(
                "swap (draft): incompatible draft weights — "
                f"{report.summary()}; rebuild the replica instead")
        new = params_from_numpy(params, self.device)
        if self._owned:
            # into the storage a captured draft program reads
            with torch.no_grad():
                for k, v in new.items():
                    self.params[k].copy_(v)
        else:
            self.params = new
        return report.to_dict()

    def own_params(self) -> None:
        """Copy the weights into storage of the drafter's own (before its
        program is captured); later swaps copy into it."""
        if not self._owned:
            self.params = {k: v.clone() for k, v in self.params.items()}
            self._owned = True


def make_drafter(kind: str, *, draft_params: Optional[Dict[str, Any]] = None,
                 draft_heads: Optional[int] = None, window: int = 16,
                 max_n: int = 3, device: DeviceLike = None) -> Drafter:
    """Build a drafter from config (``"ngram"`` or ``"model"``); a model
    drafter's weights go to ``device`` (``None``: the card)."""
    kind = (kind or "ngram").strip().lower()
    if kind == "ngram":
        return NGramDrafter(max_n=max_n)
    if kind == "model":
        if draft_params is None:
            raise MXNetError(
                "spec_draft='model' needs draft_params (a transformer_lm "
                "parameter dict for the draft model)")
        if draft_heads is None:
            raise MXNetError("spec_draft='model' needs draft_heads")
        return ModelDrafter(draft_params, heads=int(draft_heads),
                            window=window, device=device)
    raise MXNetError(f"unknown spec_draft {kind!r}, expected one of "
                     f"{DRAFT_KINDS}")
