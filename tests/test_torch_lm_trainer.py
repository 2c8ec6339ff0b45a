"""The transformer-LM training path of the PyTorch port against the JAX
package on the CPU: the ``transformer_lm`` symbol (models/transformer.py)
and ``ShardedTrainer`` (parallel/trainer.py) over a few steps.

The symbol is built by each package under a fresh NameManager: its JSON
text and inferred shapes must be equal.  The trainers get that symbol,
the same numpy parameters and token batches (labels are the next
tokens), and the JAX side a one-device mesh.  The model is small (vocab
61, 2 layers, d_model 32, 2 heads, batch 2).  Attention takes the flash
family (the kernels' plain versions in the port, the blockwise path in
JAX) at seq 128 with ``attn_block_size=64``, at the ragged seq 100 (padded
to 128 and sliced back), and at seq 1024 with the auto switch.

Tolerances:

* float32, SGD with momentum: heads within rtol 1e-4 (loss head) or atol
  1e-5 (probabilities), parameters within rtol 1e-4 / atol 1e-6
  (summation order of XLA and ATen, carried through the steps);
* float32, Adam (the benchmark's optimizer): the same, but atol 1e-5 (1 %
  of the learning rate) and the key projections' biases left out.  Their
  exact gradient is zero (each query's softmax is unchanged by a shift
  common to all its keys), so both packages feed Adam rounding noise,
  which Adam normalises into steps of up to the learning rate;
* ``compute_dtype="bfloat16"``, SGD: heads within atol 0.05, and each
  parameter of the two bf16 trainers within twice the distance that
  bf16 itself puts between either package's bf16 and f32 trainers after
  the same steps (key biases left out as above; measured: 1.0-1.4
  times).  bf16 rounds at other places in the two packages: XLA's CPU
  dot rounds the scores of the blockwise path to bf16 before the
  softmax, the port's kernels keep them in f32 and round ``p``, and the
  embedding's scatter-add accumulates in another order.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu import random as jrandom
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.parallel import flash_attention as tfa
# the port's `parallel.ring_attention` attribute is the function, as
# the JAX package's is: the module comes from sys.modules
tra = sys.modules["mxnet_tpu_torch.parallel.ring_attention"]

VOCAB, LAYERS, D, HEADS, BATCH = 61, 2, 32, 2, 2
@pytest.fixture(autouse=True)
def _keep_jax_random_state():
    """Every JAX trainer draws its base key from the JAX package's global
    PRNG: restore it, so the test files that run after this one in the
    same process draw what they would draw without it."""
    saved = dict(jrandom._state)
    yield
    jrandom._state.update(saved)


SGD = ("sgd", {"learning_rate": 0.01, "momentum": 0.9})
ADAM = ("adam", {"learning_rate": 1e-3})


def _lm_kwargs(seq, **kw):
    out = dict(vocab_size=VOCAB, num_layers=LAYERS, d_model=D, heads=HEADS,
               batch_size=BATCH, seq_len=seq)
    out.update(kw)
    return out


def _both(seq, **kw):
    with mx.name.NameManager(), mxt.name.NameManager():
        return (jmodels.get_symbol("transformer-lm", **_lm_kwargs(seq, **kw)),
                tmodels.get_symbol("transformer-lm", **_lm_kwargs(seq, **kw)))


SYMBOLS = {
    "loss_head_block64": dict(seq=128, loss_head=True, attn_block_size=64),
    "probs_head_auto": dict(seq=64),
    "ignore_label_same_dtype": dict(seq=32, ignore_label=0,
                                    head_same_dtype=True),
    "non_causal_forced_dense": dict(seq=16, causal=False,
                                    attn_block_size=-1),
}


@pytest.mark.parametrize("case", sorted(SYMBOLS))
def test_transformer_lm_symbol_matches_jax(case):
    kw = dict(SYMBOLS[case])
    seq = kw.pop("seq")
    js, ts = _both(seq, **kw)
    assert ts.tojson() == js.tojson()
    assert ts.list_arguments() == js.list_arguments()
    shapes = dict(data=(BATCH, seq), softmax_label=(BATCH, seq))
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)


def test_transformer_lm_unported_options(monkeypatch):
    """``remat`` and ``quant`` were the last options to raise; they now
    build the JAX package's symbol (scopes and fp8 attributes in the
    JSON), and the quant spec resolves as the JAX package's does."""
    for kw in (dict(remat=True), dict(quant=True), dict(quant="fp8"),
               dict(remat=True, quant="fp8")):
        js, ts = _both(64, **kw)
        assert ts.tojson() == js.tojson(), kw
    assert '"__remat_scope__": "layer1"' in _both(64, remat=True)[1].tojson()
    with pytest.raises(MXNetError, match="unknown quant"):
        tmodels.transformer_lm(quant="int4")
    monkeypatch.setenv("MXNET_TPU_QUANT", "1")
    assert '"quant": "fp8"' in tmodels.transformer_lm().tojson()
    monkeypatch.setenv("MXNET_TPU_QUANT", "off")
    assert '"quant": "fp8"' not in tmodels.transformer_lm(quant=None).tojson()
    assert '"quant": "fp8"' not in tmodels.transformer_lm(
        quant=False).tojson()


def _params(sym, seq, seed=0):
    shapes, _, _ = sym.infer_shape(data=(BATCH, seq),
                                   softmax_label=(BATCH, seq))
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in zip(sym.list_arguments(), shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            out[n] = (1.0 + 0.1 * rng.randn(*s)).astype(np.float32)
        else:
            out[n] = (0.1 * rng.randn(*s)).astype(np.float32)
    return out


def _batches(seq, n, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, VOCAB, (BATCH, seq + 1))
        out.append({"data": toks[:, :-1].astype(np.float32),
                    "softmax_label": toks[:, 1:].astype(np.float32)})
    return out


def _pair(seq, opt, compute_dtype=None, fused=None, **kw):
    js, ts = _both(seq, **kw)
    args = _params(ts, seq)
    shapes = ({"data": (BATCH, seq)}, {"softmax_label": (BATCH, seq)})
    jt = JaxTrainer(js, optimizer=opt[0], optimizer_params=dict(opt[1]),
                    mesh=make_mesh({"data": 1}, jax.devices()[:1]),
                    compute_dtype=compute_dtype)
    jt.bind(*shapes, arg_params={k: jnp.asarray(v) for k, v in args.items()})
    tt = ShardedTrainer(ts, optimizer=opt[0], optimizer_params=dict(opt[1]),
                        compute_dtype=compute_dtype, fused_update=fused,
                        device="cpu")
    tt.bind(*shapes, arg_params=args)
    return jt, tt, args


TRAIN = {
    # name: (seq, steps, optimizer, symbol options)
    "seq128_block64_loss_sgd": (128, 3, SGD, dict(loss_head=True,
                                                  attn_block_size=64)),
    "seq128_block64_probs_sgd": (128, 3, SGD, dict(attn_block_size=64)),
    "seq100_ragged_loss_sgd": (100, 3, SGD, dict(loss_head=True,
                                                 attn_block_size=64)),
    "seq1024_auto_loss_sgd": (1024, 1, SGD, dict(loss_head=True)),
    "seq128_block64_loss_adam": (128, 3, ADAM, dict(loss_head=True,
                                                    attn_block_size=64)),
}


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_lm_trainer_matches_jax(case):
    seq, steps, opt, kw = TRAIN[case]
    jt, tt, _ = _pair(seq, opt, **kw)
    assert tt._fused
    loss_head = kw.get("loss_head", False)
    adam = opt is ADAM
    for si, batch in enumerate(_batches(seq, steps)):
        dense0 = tra.local_attention.dense_calls
        blockwise0 = tra.blockwise_attention.calls
        jh = np.asarray(jt.step(batch)[0])
        th = tt.step(batch)[0].numpy()
        # the port's attention took the flash family (the kernels' plain
        # versions on the CPU), never the dense or blockwise path
        assert tra.local_attention.dense_calls == dense0
        assert tra.blockwise_attention.calls == blockwise0
        assert th.shape == jh.shape == ((BATCH * seq,) if loss_head
                                        else (BATCH * seq, VOCAB))
        if loss_head:
            np.testing.assert_allclose(th, jh, rtol=1e-4, atol=0,
                                       err_msg=f"heads, step {si}")
        else:
            np.testing.assert_allclose(th, jh, rtol=0, atol=1e-5,
                                       err_msg=f"heads, step {si}")
        jargs, targs = jt.get_params()[0], tt.get_params()[0]
        for n in jargs:
            if adam and n.endswith("_k_bias"):
                continue
            np.testing.assert_allclose(
                targs[n].asnumpy(), jargs[n].asnumpy(), rtol=1e-4,
                atol=1e-5 if adam else 1e-6, err_msg=f"{n}, step {si}")


def test_lm_trainer_bf16_compute_matches_jax_sgd():
    seq = 128
    kw = dict(loss_head=True, attn_block_size=64)
    jt, tt, args = _pair(seq, SGD, compute_dtype="bfloat16", **kw)
    j32, t32, _ = _pair(seq, SGD, **kw)
    assert tt.compute_dtype == torch.bfloat16
    for si, batch in enumerate(_batches(seq, 3)):
        jh = np.asarray(jt.step(batch)[0])
        th = tt.step(batch)[0]
        j32.step(batch)
        t32.step(batch)
        assert th.dtype == torch.float32            # the loss head is f32
        np.testing.assert_allclose(th.numpy(), jh, rtol=0, atol=0.05,
                                   err_msg=f"heads, step {si}")
    (jargs, _), (targs, _) = jt.get_params(), tt.get_params()
    (j32a, _), (t32a, _) = j32.get_params(), t32.get_params()
    for n in args:
        assert targs[n].asnumpy().dtype == np.float32   # f32 masters
        if n.endswith("_k_bias"):
            continue
        cross = np.abs(targs[n].asnumpy() - jargs[n].asnumpy()).max()
        noise = max(np.abs(jargs[n].asnumpy() - j32a[n].asnumpy()).max(),
                    np.abs(targs[n].asnumpy() - t32a[n].asnumpy()).max())
        assert cross <= 2.0 * noise, (n, cross, noise)


def test_lm_fused_adam_is_bitwise_unfused():
    seq = 128
    kw = dict(loss_head=True, attn_block_size=64)
    _, fused, _ = _pair(seq, ADAM, fused=True, **kw)
    _, plain, _ = _pair(seq, ADAM, fused=False, **kw)
    assert fused._fused_kind == "adam" and not plain._fused
    for batch in _batches(seq, 2):
        fh, ph = fused.step(batch)[0], plain.step(batch)[0]
        assert torch.equal(fh, ph)
    fs = fused.opt_state_by_param()
    for n in fused._param_names:
        assert torch.equal(fused._params[n], plain._params[n]), n
        for a, b in zip(fs[n], plain._opt_state[n]):
            assert torch.equal(a, b), n


def test_compute_dtype_casts_at_the_forward_edge():
    seq = 64
    _, tt, _ = _pair(seq, SGD, compute_dtype="bfloat16", loss_head=True,
                     attn_block_size=64)
    cast = tt._cast_params()
    assert all(v.dtype == torch.bfloat16 for v in cast.values())
    assert all(p.dtype == torch.float32 for p in tt._params.values())
    heads = tt.forward(_batches(seq, 1)[0])
    assert heads[0].dtype == torch.float32
    with pytest.raises(MXNetError, match="floating-point"):
        ShardedTrainer(tt.symbol, compute_dtype="int8", device="cpu")


def test_cuda_launch_counters_start_at_zero_on_cpu_runs():
    """A CPU run of the LM launches no kernel: the counters that
    chip_smoke.py reads on the card move only on CUDA tensors."""
    before = (tfa.flash_fwd.launches, tfa.flash_bwd.launches)
    _, tt, _ = _pair(128, SGD, loss_head=True, attn_block_size=64)
    tt.step(_batches(128, 1)[0])
    assert (tfa.flash_fwd.launches, tfa.flash_bwd.launches) == before
