"""Learning-rate schedulers of the PyTorch port (mxnet_tpu_torch/
lr_scheduler.py) and the optimizer's base-rate hand-over, against the JAX
package's.

Every scheduler, alone and behind a ``WarmupScheduler``, gives the same
Python float as the JAX package's (compared with ``==``) at every update
count 0-200, called in order as the trainer calls them.  The eight cases
of ``tests/test_lr_scheduler.py`` (the precedence of an optimizer's
``learning_rate``, a scheduler's explicit ``base_lr`` and a warmup
wrapper's) run on both packages with equal results.
"""
import pytest

from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import optimizer as jopt

from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError

SCHEDULES = {
    "factor": lambda m: m.FactorScheduler(step=7, factor=0.7),
    "factor_floor": lambda m: m.FactorScheduler(step=3, factor=0.5,
                                                stop_factor_lr=1e-4),
    "multifactor": lambda m: m.MultiFactorScheduler(step=[5, 40, 41, 150],
                                                    factor=0.3),
    "cosine": lambda m: m.CosineScheduler(120, final_lr=1e-3),
    "cosine_explicit": lambda m: m.CosineScheduler(90, base_lr=0.3),
}


def _run(sched):
    return [sched(i) for i in range(201)]


@pytest.mark.parametrize("warmup", [None, 10], ids=["alone", "warmup"])
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_values_equal_jax(name, warmup):
    j, t = SCHEDULES[name](jlrs), SCHEDULES[name](tlrs)
    if warmup:
        j = jlrs.WarmupScheduler(warmup, after=j)
        t = tlrs.WarmupScheduler(warmup, after=t)
    assert _run(t) == _run(j)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_through_the_optimizer_equals_jax(name):
    """The optimizer hands its learning rate to the scheduler; the
    imperative ``_get_lr`` reads it at the update count."""
    j = jopt.create("sgd", learning_rate=0.05,
                    lr_scheduler=jlrs.WarmupScheduler(
                        4, after=SCHEDULES[name](jlrs)))
    t = topt.create("sgd", learning_rate=0.05,
                    lr_scheduler=tlrs.WarmupScheduler(
                        4, after=SCHEDULES[name](tlrs)))
    got, want = [], []
    for i in range(60):
        for o, out in ((j, want), (t, got)):
            o.num_update = i
            out.append(o._get_lr(0))
    assert got == want


def _both(build):
    return build(jopt, jlrs), build(topt, tlrs)


def test_optimizer_lr_wins_over_explicit_inner():
    for o in _both(lambda op, ls: op.create(
            "sgd", learning_rate=0.1, lr_scheduler=ls.WarmupScheduler(
                10, after=ls.CosineScheduler(100, base_lr=0.01)))):
        assert o.lr_scheduler(9) == pytest.approx(0.1)
        assert o.lr_scheduler(10) == pytest.approx(0.1, rel=1e-3)


def test_optimizer_lr_wins_over_explicit_flat_scheduler():
    for o in _both(lambda op, ls: op.create(
            "sgd", learning_rate=0.05,
            lr_scheduler=ls.CosineScheduler(100, base_lr=3e-4))):
        assert o.lr_scheduler.base_lr == pytest.approx(0.05)


def test_explicit_scheduler_backfills_optimizer_lr():
    for o in _both(lambda op, ls: op.create(
            "sgd", lr_scheduler=ls.CosineScheduler(100, base_lr=3e-4))):
        assert o.lr == pytest.approx(3e-4)
        assert o.lr_scheduler.base_lr == pytest.approx(3e-4)


def test_implicit_everywhere_uses_class_default():
    for op, ls in ((jopt, jlrs), (topt, tlrs)):
        assert op.create("sgd").lr == pytest.approx(0.01)
        assert op.create("adam").lr == pytest.approx(0.001)
        assert op.create("rmsprop").lr == pytest.approx(0.002)
        o = op.create("sgd", lr_scheduler=ls.FactorScheduler(step=5,
                                                             factor=0.5))
        assert o.lr_scheduler.base_lr == pytest.approx(0.01)


def test_wrapper_implicit_adopts_explicit_inner():
    for ls in (jlrs, tlrs):
        s = ls.WarmupScheduler(10, after=ls.CosineScheduler(90,
                                                           base_lr=0.001))
        assert s(9) == pytest.approx(0.001)
        assert s(10) == pytest.approx(0.001, rel=1e-3)


def test_both_explicit_without_optimizer_jump_is_honored():
    for ls in (jlrs, tlrs):
        s = ls.WarmupScheduler(10, after=ls.CosineScheduler(100,
                                                           base_lr=0.3),
                               base_lr=0.1)
        assert s(9) == pytest.approx(0.1)
        assert s(10) == pytest.approx(0.3, rel=1e-3)


def test_warmup_propagates_optimizer_lr_to_implicit_inner():
    for o in _both(lambda op, ls: op.create(
            "sgd", learning_rate=0.2, lr_scheduler=ls.WarmupScheduler(
                10, after=ls.FactorScheduler(step=50, factor=0.5)))):
        assert o.lr_scheduler(12) == pytest.approx(0.2)


def test_explicit_inner_behind_warmup_backfills_optimizer_lr():
    for o in _both(lambda op, ls: op.create(
            "sgd", lr_scheduler=ls.WarmupScheduler(
                10, after=ls.CosineScheduler(100, base_lr=3e-4)))):
        assert o.lr == pytest.approx(3e-4)
        assert o.lr_scheduler(9) == pytest.approx(3e-4)


@pytest.mark.parametrize("make", [
    lambda m: m.FactorScheduler(step=0),
    lambda m: m.FactorScheduler(step=2, factor=1.5),
    lambda m: m.MultiFactorScheduler(step=[3, 3]),
    lambda m: m.MultiFactorScheduler(step=[]),
    lambda m: m.WarmupScheduler(0),
    lambda m: m.CosineScheduler(0),
])
def test_bad_arguments_raise_in_both(make):
    from mxnet_tpu.base import MXNetError as JaxError
    with pytest.raises(JaxError):
        make(jlrs)
    with pytest.raises(MXNetError):
        make(tlrs)
