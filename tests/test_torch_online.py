"""Serving and post-training from checkpoints in the PyTorch port
(``predictor.load_weights``, ``Engine.from_checkpoint``, swaps from a
path, ``online/compat.py``'s manifest half, ``online/loop.py``) against
the JAX package, on the CPU, at the serve tests' size (vocab 61, 2
layers, d 32, 4 heads).

* ``Engine.from_checkpoint`` on a directory either package wrote gives
  greedy streams equal to the JAX engine's from the same directory, and a
  legacy prefix loads too.
* ``Engine.swap_weights`` and ``Router.rolling_swap`` from a checkpoint
  path: hot, and the streams become those of an engine built on the new
  weights.
* ``signature_of_manifest`` and ``compat_stamp`` equal the JAX
  package's, for a trainer's and a model's checkpoint.
* ``OnlineLoop`` over 2 rounds of greedy rollouts (so both packages draw
  the same tokens) equals the JAX loop: rollouts, rewards, kept rows,
  steps, swap modes and the published stamps; the trainers' parameters
  within rtol 1e-4, atol 1e-6 (summation order); the fleet then serves
  the published weights.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import random as jrandom
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.checkpoint import CheckpointManager as JMgr
from mxnet_tpu.online import (OnlineConfig as JOnlineConfig,
                              OnlineLoop as JOnlineLoop)
from mxnet_tpu.online import compat as jcompat
from mxnet_tpu.online import make_rollout_trainer as jmake_trainer
from mxnet_tpu.parallel import make_mesh
from mxnet_tpu.serve import (Engine as JEngine, EngineConfig as JConfig,
                             Router as JRouter, RouterConfig as JRConfig)

import mxnet_tpu_torch as mxt
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.checkpoint import CheckpointManager, read_manifest
from mxnet_tpu_torch.checkpoint import layout
from mxnet_tpu_torch.models.transformer import init_params
from mxnet_tpu_torch.online import (OnlineConfig, OnlineLoop, compat,
                                    make_rollout_trainer)
from mxnet_tpu_torch.serve import Engine, EngineConfig, Router, RouterConfig

V, NL, D, H = 61, 2, 32, 4
A = init_params(V, NL, D, seed=0)
B = init_params(V, NL, D, seed=1)
ECFG = dict(heads=H, block_size=4, num_blocks=64, max_batch=4,
            max_prompt_len=16, max_seq_len=48, prompt_bucket_min=8)
_RS = np.random.RandomState(7)
PROMPTS = [list(map(int, _RS.randint(1, V, _RS.randint(3, 10))))
           for _ in range(4)]
KW = dict(max_new_tokens=10, temperature=0.0)


@pytest.fixture(autouse=True)
def _fresh_state():
    saved = dict(jrandom._state)
    jtel.reset_for_tests()
    ttel.reset_for_tests()
    yield
    jtel.reset_for_tests()
    ttel.reset_for_tests()
    jrandom._state.update(saved)


def _streams(eng, prompts=PROMPTS):
    ids = [eng.submit(p, **KW) for p in prompts]
    eng.run()
    return [list(eng.requests[i].tokens) for i in ids]


def _publish(Mgr, root, params, step=1):
    mgr = Mgr(str(root))
    mgr.save_model(step, None, {k: np.asarray(v) for k, v in params.items()},
                   {}, blocking=True)
    mgr.close()
    return str(root)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_engine_from_checkpoint_matches_jax_engine(tmp_path, writer):
    root = _publish(JMgr if writer == "jax" else CheckpointManager,
                    tmp_path / "ckpt", A)
    tengine = Engine.from_checkpoint(root, EngineConfig(**ECFG),
                                     device="cpu")
    jengine = JEngine.from_checkpoint(root, JConfig(**ECFG))
    want = _streams(jengine)
    assert _streams(tengine) == want and all(want)
    # a legacy prefix and a .params path load the same weights
    prefix = str(tmp_path / "legacy")
    with mxt.name.NameManager():
        sym = mxt.models.transformer_lm(vocab_size=V, num_layers=NL,
                                        d_model=D, heads=H)
    mxt.model.save_checkpoint(prefix, 4, sym, {
        k: mxt.nd.array(np.asarray(v), ctx=mxt.cpu()) for k, v in A.items()},
        {})
    for src, epoch in ((prefix, 4), (prefix + "-0004.params", None)):
        eng = Engine.from_checkpoint(src, EngineConfig(**ECFG), epoch=epoch,
                                     device="cpu")
        assert _streams(eng) == want


def test_swaps_from_a_checkpoint_path(tmp_path):
    root = _publish(JMgr, tmp_path / "b", B)
    want = _streams(Engine(B, EngineConfig(**ECFG), device="cpu"))
    eng = Engine(A, EngineConfig(**ECFG), device="cpu")
    assert _streams(eng) != want
    report = eng.swap_weights(root)
    assert report["compatible"] and eng.swap_count == 1
    assert _streams(eng) == want
    router = Router(A, EngineConfig(**ECFG), RouterConfig(replicas=2),
                    device="cpu")
    router.warmup()
    swap = router.rolling_swap(root)
    assert swap["mode"] == "hot" and len(swap["swap_ms"]) == 2
    ids = [router.submit(p, **KW) for p in PROMPTS]
    router.run()
    assert [list(router.request(i).tokens) for i in ids] == want
    jrouter = JRouter(A, engine_config=JConfig(**ECFG),
                      config=JRConfig(replicas=2), chaos={})
    jrouter.warmup()
    assert jrouter.rolling_swap(root)["mode"] == swap["mode"]


def test_manifest_signature_and_stamp_match_jax(tmp_path):
    tstamp = compat.compat_stamp(A, heads=H)
    assert tstamp == jcompat.compat_stamp(A, heads=H)
    assert (compat.compat_stamp({"w": np.zeros(3, np.float32)})
            == jcompat.compat_stamp({"w": np.zeros(3, np.float32)}))
    root = _publish(CheckpointManager, tmp_path / "model", A)
    man = read_manifest(layout.step_path(root, 1))
    sig = compat.signature_of_manifest(man)
    assert sig == jcompat.signature_of_manifest(man)
    assert sig == compat.signature_of_params(A)
    # a trainer checkpoint names its weights param: and holds opt: state
    tr = make_rollout_trainer(A, heads=H, batch=2, seq_len=8, device="cpu",
                              optimizer_params={"learning_rate": 0.05,
                                                "momentum": 0.9})
    mgr = CheckpointManager(str(tmp_path / "trainer"))
    tr.save_state(mgr, blocking=True)
    mgr.close()
    tman = read_manifest(mgr.step_path(0))
    assert any(k.startswith("opt:") for k in tman["arrays"])
    assert compat.signature_of_manifest(tman) == sig
    assert jcompat.signature_of_manifest(tman) == sig
    raw = {"arrays": {"aux:m": man["arrays"]["arg:embed_weight"],
                      "w": man["arrays"]["arg:embed_weight"]}}
    assert (compat.signature_of_manifest(raw)
            == jcompat.signature_of_manifest(raw) == {"w": sig[
                "embed_weight"]})


def _loop_prompts(round_idx, n):
    rng = np.random.RandomState(11 + round_idx)
    return [list(map(int, rng.randint(1, V, 3))) for _ in range(n)]


def _reward(prompt, toks):
    return float(len(set(toks)))


def test_online_loop_matches_jax(tmp_path):
    cfg = dict(rounds=2, rollouts=4, max_new_tokens=6, train_steps=2,
               temperature=0.0)
    jrouter = JRouter(A, engine_config=JConfig(**ECFG),
                      config=JRConfig(replicas=2), chaos={})
    jrouter.warmup()
    jtrainer = jmake_trainer(A, heads=H, batch=4, seq_len=24,
                             mesh=make_mesh({"data": 1}, jax.devices()[:1]))
    jmgr = JMgr(str(tmp_path / "jax"))
    jres = JOnlineLoop(jrouter, jtrainer, jmgr, prompt_fn=_loop_prompts,
                       reward_fn=_reward, config=JOnlineConfig(**cfg),
                       base_seed=500).run()
    router = Router(A, EngineConfig(**ECFG), RouterConfig(replicas=2),
                    device="cpu")
    router.warmup()
    trainer = make_rollout_trainer(A, heads=H, batch=4, seq_len=24,
                                   device="cpu")
    mgr = CheckpointManager(str(tmp_path / "port"))
    res = OnlineLoop(router, trainer, mgr, prompt_fn=_loop_prompts,
                     reward_fn=_reward, config=OnlineConfig(**cfg),
                     base_seed=500).run()
    assert len(res) == len(jres) == 2
    for r, j in zip(res, jres):
        for k in ("round", "step", "rollout_tokens", "kept", "rewards"):
            assert r[k] == j[k], k
        assert r["swap"]["mode"] == j["swap"]["mode"] == "hot"
        assert r["swap"]["report"] == j["swap"]["report"]
        tm = read_manifest(mgr.step_path(r["step"]))["meta"]
        jm = read_manifest(jmgr.step_path(j["step"]))["meta"]
        assert tm["compat"] == jm["compat"]
        assert tm["online_round"] == jm["online_round"]
    assert sum(res[0]["kept"]) == 2 and res[0]["rollout_tokens"] > 0
    assert all(rep.engine.swap_count == 2 for rep in router.replicas)
    ta, ja = trainer.get_params()[0], jtrainer.get_params()[0]
    for n in ja:
        np.testing.assert_allclose(ta[n].asnumpy(), ja[n].asnumpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    served = router.replicas[1].engine._params
    for n, v in ta.items():
        assert torch.equal(served[n], torch.from_numpy(v.asnumpy()))
    mgr.close()
    jmgr.close()
