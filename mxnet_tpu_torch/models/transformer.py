"""Decoder-only transformer LM: the training symbol and the functional
twins the serve tier runs.

Counterpart of ``mxnet_tpu/models/transformer.py``.
:func:`transformer_lm` builds the same Symbol as the JAX package (same
node names, parameters and JSON): an Embedding, ``num_layers`` pre-norm
blocks whose attention is ``RingAttention(layout="blhd")`` over
``[B, L, H, hd]`` (the flash kernels K3/K4 from seq 1024 on, or with an
explicit ``attn_block_size``), a final LayerNorm, the ``lm_head`` and a
SoftmaxOutput head (probabilities, or per-token cross-entropy with
``loss_head=True``).  ``quant`` resolves as the JAX package's
``quant.resolve_quant`` does (``MXNET_TPU_QUANT`` included); fp8 linears
and ``remat`` are not ported yet and raise.

The functional twins take the JAX package's own parameter dict
(``embed_weight``, ``layer{i}_q_weight``, ``final_ln_gamma``, ...) as
tensors and keep its layouts at the public functions: ``[B, L, H, hd]``
states and ``[out, in]`` FC weights.  Each op mirrors the registered
symbol op: FullyConnected is ``x @ W.T + b``, LayerNorm takes f32
statistics with eps ``1e-5``, attention in prefill is the dense causal
path.

:func:`init_params` makes the dict the JAX tests and ``bench.py`` make
(same names, shapes, order and seeded values) without the symbol API, and
:func:`params_from_numpy` carries such a dict onto a device.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import symbol as sym
from ..base import MXNetError, not_ported
from ..context import DeviceLike, resolve_device
from ..ops.nn_ops import layer_norm
from ..parallel.ring_attention import NEG_INF, local_attention

__all__ = ["transformer_block", "transformer_lm", "lm_config_from_params",
           "param_shapes", "init_params", "params_from_numpy",
           "transformer_lm_prefill", "transformer_lm_decode",
           "transformer_lm_decode_dense"]

_LN_EPS = 1e-5   # LayerNorm op default of the JAX package


# ---------------------------------------------------------------------------
# The training symbol
# ---------------------------------------------------------------------------

def _resolve_quant(quant) -> bool:
    """The JAX package's ``quant.resolve_quant`` reduced to its answer:
    True when the spec (None consults ``MXNET_TPU_QUANT``) asks for fp8."""
    if quant is None:
        raw = os.environ.get("MXNET_TPU_QUANT", "").strip().lower()
        if not raw or raw in ("0", "off", "false", "no"):
            return False
        quant = True
    if quant is False:
        return False
    if quant is True or quant == "fp8":
        return True
    raise MXNetError(f"unknown quant spec {quant!r}: expected None, bool, "
                     "'fp8', or a QuantConfig")


def _linear(x, b, l, d_in, d_out, name, quant=""):
    """Per-position linear: [B, L, d_in] -> [B, L, d_out], the batch dim
    a -1 wildcard."""
    h = sym.Reshape(data=x, shape=(-1, d_in))
    h = sym.FullyConnected(data=h, num_hidden=d_out, name=name, quant=quant)
    return sym.Reshape(data=h, shape=(-1, l, d_out))


def _layernorm(x, name):
    return sym.LayerNorm(data=x, name=name)


def transformer_block(x, b, l, d, heads, name, causal=True,
                      attn_block_size=0, quant=""):
    """One pre-norm block; heads stay at dim 2 ([B, L, H, hd]) and
    ``RingAttention(layout='blhd')`` reads them in place."""
    hd = d // heads

    def split_heads(t):
        return sym.Reshape(data=t, shape=(-1, l, heads, hd))

    h = _layernorm(x, f"{name}_ln1")
    q = split_heads(_linear(h, b, l, d, d, f"{name}_q", quant=quant))
    k = split_heads(_linear(h, b, l, d, d, f"{name}_k", quant=quant))
    v = split_heads(_linear(h, b, l, d, d, f"{name}_v", quant=quant))
    att = sym.RingAttention(query=q, key=k, value=v, causal=causal,
                            block_size=attn_block_size, layout="blhd",
                            name=f"{name}_attn")
    att = sym.Reshape(data=att, shape=(-1, l, d))
    att = _linear(att, b, l, d, d, f"{name}_proj", quant=quant)
    x = x + att
    h = _layernorm(x, f"{name}_ln2")
    h = _linear(h, b, l, d, 4 * d, f"{name}_ffn1", quant=quant)
    h = sym.Activation(data=h, act_type="relu")
    h = _linear(h, b, l, 4 * d, d, f"{name}_ffn2", quant=quant)
    return x + h


def transformer_lm(vocab_size=256, num_layers=2, d_model=64, heads=4,
                   batch_size=8, seq_len=64, causal=True, remat=False,
                   head_same_dtype=False, loss_head=False,
                   attn_block_size=0, ignore_label=None, quant=None):
    """The LM symbol; inputs ``data``/``softmax_label`` are ``[batch,
    seq]`` token ids.  ``loss_head=True`` emits the per-token
    cross-entropy (``[batch * seq]`` f32) instead of the probabilities,
    with the same gradients; ``ignore_label`` masks those positions out of
    the loss and its gradient; ``head_same_dtype`` emits probabilities in
    the activation type."""
    if remat:
        raise not_ported("transformer_lm(remat=True) (remat_scope)")
    if _resolve_quant(quant):
        raise not_ported("transformer_lm(quant='fp8') (quant.py)")
    b, l, d = batch_size, seq_len, d_model
    net = sym.Embedding(data=sym.Variable("data"), input_dim=vocab_size,
                        output_dim=d, name="embed")
    for i in range(num_layers):
        net = transformer_block(net, b, l, d, heads, f"layer{i}",
                                causal=causal,
                                attn_block_size=attn_block_size, quant="")
    net = _layernorm(net, "final_ln")
    net = sym.Reshape(data=net, shape=(-1, d))
    net = sym.FullyConnected(data=net, num_hidden=vocab_size, name="lm_head")
    label = sym.Reshape(data=sym.Variable("softmax_label"), shape=(-1,))
    head_kwargs = {}
    if ignore_label is not None:
        head_kwargs = dict(use_ignore=True, ignore_label=ignore_label)
    return sym.SoftmaxOutput(data=net, label=label, name="softmax",
                             out_dtype="same" if head_same_dtype else "",
                             out_mode="loss" if loss_head else "",
                             **head_kwargs)


# ---------------------------------------------------------------------------
# Functional twins
# ---------------------------------------------------------------------------


def _fcm(x, weight, bias):
    """Mirror of the FullyConnected op on [..., d_in] activations."""
    lead = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1])
    if h.dtype != weight.dtype:
        h = h.to(weight.dtype)
    h = torch.matmul(h, weight.t()) + bias.to(weight.dtype)
    return h.reshape(lead + (weight.shape[0],))


def _lnm(x, gamma, beta):
    """The LayerNorm op at its default eps."""
    return layer_norm(x, gamma, beta, _LN_EPS)


def _param(params, name):
    try:
        return params[name]
    except KeyError:
        raise MXNetError(f"transformer_lm params missing {name!r} — not a "
                         "transformer_lm parameter dict?")


def lm_config_from_params(params) -> Tuple[int, int, int]:
    """Infer ``(vocab_size, num_layers, d_model)`` from a transformer_lm
    parameter dict (heads must come from the caller)."""
    embed = _param(params, "embed_weight")
    n = 0
    while f"layer{n}_q_weight" in params:
        n += 1
    if n == 0:
        raise MXNetError("no layer0_q_weight: not transformer_lm params")
    return int(embed.shape[0]), n, int(embed.shape[1])


def param_shapes(vocab: int, num_layers: int,
                 d_model: int) -> List[Tuple[str, Tuple[int, ...]]]:
    """Names and shapes of a transformer_lm parameter dict, in the order
    of the JAX symbol's ``list_arguments()``."""
    d, out = d_model, [("embed_weight", (vocab, d_model))]
    for i in range(num_layers):
        out += [(f"layer{i}_ln1_gamma", (d,)), (f"layer{i}_ln1_beta", (d,))]
        for nm in ("q", "k", "v", "proj"):
            out += [(f"layer{i}_{nm}_weight", (d, d)),
                    (f"layer{i}_{nm}_bias", (d,))]
        out += [(f"layer{i}_ln2_gamma", (d,)), (f"layer{i}_ln2_beta", (d,)),
                (f"layer{i}_ffn1_weight", (4 * d, d)),
                (f"layer{i}_ffn1_bias", (4 * d,)),
                (f"layer{i}_ffn2_weight", (d, 4 * d)),
                (f"layer{i}_ffn2_bias", (d,))]
    out += [("final_ln_gamma", (d,)), ("final_ln_beta", (d,)),
            ("lm_head_weight", (vocab, d)), ("lm_head_bias", (vocab,))]
    return out


def init_params(vocab: int, num_layers: int, d_model: int,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """Random transformer_lm weights as numpy f32 arrays:
    ``RandomState(seed).randn(*shape) * 0.05`` drawn in
    :func:`param_shapes` order, the recipe of the JAX package's serve
    tests and benchmark."""
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.05).astype(np.float32)
            for n, s in param_shapes(vocab, num_layers, d_model)}


def params_from_numpy(params, device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """Carry a parameter dict (numpy arrays, objects with ``asnumpy()``,
    or tensors) onto ``device`` as ``dtype`` tensors.  FC weights are
    ``[out, in]`` on both sides, so nothing is transposed."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        if hasattr(v, "asnumpy"):
            v = v.asnumpy()
        out[k] = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                 else v).to(device=dev, dtype=dtype)
    return out


def _block_step(params, i, h, attend):
    """One transformer block on hidden states ``h`` ([..., d]);
    ``attend(q, k, v)`` owns the KV story."""
    def p(suffix):
        return _param(params, f"layer{i}_{suffix}")

    hn = _lnm(h, p("ln1_gamma"), p("ln1_beta"))
    q, k, v = (_fcm(hn, p(f"{nm}_weight"), p(f"{nm}_bias"))
               for nm in ("q", "k", "v"))
    att = attend(q, k, v)
    att = _fcm(att, p("proj_weight"), p("proj_bias"))
    h = h + att
    hn = _lnm(h, p("ln2_gamma"), p("ln2_beta"))
    f = _fcm(hn, p("ffn1_weight"), p("ffn1_bias"))
    f = torch.clamp_min(f, 0)
    return h + _fcm(f, p("ffn2_weight"), p("ffn2_bias"))


def _lm_head(params, h):
    h = _lnm(h, _param(params, "final_ln_gamma"),
             _param(params, "final_ln_beta"))
    return _fcm(h, _param(params, "lm_head_weight"),
                _param(params, "lm_head_bias"))


def _embed(params, tokens):
    return _param(params, "embed_weight")[tokens.long()]


def transformer_lm_prefill(params, tokens, *, heads):
    """Causal forward over full prompts, emitting the KV states.

    ``tokens``: [B, L] ids.  Returns ``(logits [B, L, V], ks, vs)`` with
    per-layer [B, L, H, hd] states, exactly what a cache stores.
    """
    vocab, num_layers, d = lm_config_from_params(params)
    if d % heads:
        raise MXNetError(f"d_model {d} not divisible by heads {heads}")
    hd = d // heads
    b, l = tokens.shape
    h = _embed(params, tokens)
    ks, vs = [], []

    def attend(q, k, v):
        q, k, v = (t.reshape(b, l, heads, hd) for t in (q, k, v))
        ks.append(k)
        vs.append(v)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out = local_attention(qt, kt, vt, causal=True)
        return out.transpose(1, 2).reshape(b, l, d)

    for i in range(num_layers):
        h = _block_step(params, i, h, attend)
    return _lm_head(params, h), ks, vs


def transformer_lm_decode(params, tokens, *, heads, attend):
    """One incremental decode step over a caller-owned KV cache.

    ``tokens``: [B] ids.  ``attend(layer, q, k, v)`` receives the new
    per-head states ([B, H, hd] each), must extend the cache with ``k``/
    ``v`` and return ``q``'s attention over the cached prefix, new
    position included, as [B, H, hd].  Returns next-token logits [B, V].
    """
    vocab, num_layers, d = lm_config_from_params(params)
    hd = d // heads
    b = tokens.shape[0]
    h = _embed(params, tokens)

    def make_attend(i):
        def _attend(q, k, v):
            q, k, v = (t.reshape(b, heads, hd) for t in (q, k, v))
            return attend(i, q, k, v).reshape(b, d)
        return _attend

    for i in range(num_layers):
        h = _block_step(params, i, h, make_attend(i))
    return _lm_head(params, h)


def transformer_lm_decode_dense(params, tokens, lengths, k_cache, v_cache,
                                *, heads):
    """Dense-cache decode step over [num_layers, B, L_max, H, hd] caches.

    ``lengths``: [B] entries already cached; the new token is written at
    position ``lengths``.  The caches are updated in place (the JAX twin
    returns new arrays).  Returns ``(logits [B, V], k_cache, v_cache)``.
    """
    b = tokens.shape[0]
    rows = torch.arange(b, device=tokens.device)
    lengths = lengths.long()
    d = _param(params, "embed_weight").shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(d // heads),
                                          device=tokens.device))

    def attend(i, q, k, v):
        k_cache[i, rows, lengths] = k
        v_cache[i, rows, lengths] = v
        kc, vc = k_cache[i], v_cache[i]
        s = (torch.einsum("bhd,blhd->bhl", q, kc) * scale).float()
        pos = torch.arange(kc.shape[1], device=q.device)
        valid = pos[None, :] < (lengths + 1)[:, None]
        s = s.masked_fill(~valid[:, None, :], NEG_INF)
        probs = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhl,blhd->bhd", probs, vc)

    logits = transformer_lm_decode(params, tokens, heads=heads, attend=attend)
    return logits, k_cache, v_cache

