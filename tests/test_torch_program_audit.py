"""The program auditor of the PyTorch port
(``mxnet_tpu_torch/analysis/program.py``) against the JAX package's
(``mxnet_tpu/analysis/program.py``), in one process, on the CPU.

Each comparison builds the same nets at the JAX tests' sizes (the FC
classifier on 16x8 batches; the transformer LM at vocab 128, 2 layers,
d 64, batch 8, sequence 16) in both packages, records the port's step
programs (the aten ops and kernel notes of one run of each body) and
traces the JAX ones, and holds the two where they agree by design:

* the seeded program corpora fire the same rules, and their negative
  controls stay silent; the JAX corpus's ``hbm_bytes_quantized`` is the
  one exception (its one-device reduction leaves no collective in the
  jaxpr, ROADMAP Queue 3), and the port's runs it over two members;
* the FC, LM and guarded trainers audit clean, with every fused bucket
  at 1 read and 1 write; the unfused update and the guardrails cost
  passes in both (the counts differ: aten and jaxprs decompose the
  update differently, so the port's are stated beside JAX's);
* the optimizer step, an executor's aux carries and the int8 wire
  itemsize over two data members audit alike.

Within the port: auditing changes nothing (parameters, optimizer and
random state bitwise; the next step equals an unaudited twin's), the
capture observers see the compiled programs and none stays registered,
the serving engine's programs are clean with 1-byte fp8 KV reads (a
plain pool fires ``program.hbm-bytes``), and the recorder keeps no
tensor alive.
"""
import gc
import importlib.util
import os
import weakref

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as jmx
from mxnet_tpu import analysis as janalysis
from mxnet_tpu import random as jrandom
from mxnet_tpu.analysis.program import AuditConfig as JAuditConfig
from mxnet_tpu.parallel import ShardedTrainer as JTrainer
from mxnet_tpu.parallel import make_mesh as jmake_mesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import analysis as tanalysis
from mxnet_tpu_torch import compile_cache as tcc
from mxnet_tpu_torch import profiler as tprofiler
from mxnet_tpu_torch.analysis import program as tprogram
from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX audits skip XLA's compile (the carry-sharding check, which has
# no port meaning); every rule compared here runs on the jaxpr
JCFG = JAuditConfig(compile=False)

# the port's unfused SGD-momentum update over the FC net: rescale,
# decay, rate, momentum, weight and the two in-place writes back; the
# JAX jaxpr of the same update reads each bucket 5 times
PORT_UNFUSED_FC_PASSES = 7
JAX_UNFUSED_FC_PASSES = 5


@pytest.fixture(autouse=True)
def _keep_random_state():
    """Both packages' global key sequences and the port's generators,
    restored after the test (later files draw what they would draw)."""
    from mxnet_tpu_torch import random as port_random
    jsaved = dict(jrandom._state)
    saved = dict(port_random._state)
    gens = {d: g.get_state() for d, g in port_random._generators.items()}
    yield
    jrandom._state.update(jsaved)
    port_random._state.update(saved)
    for d in list(port_random._generators):
        if d in gens:
            port_random._generators[d].set_state(gens[d])
        else:
            del port_random._generators[d]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT_CORPUS = _load(os.path.join(REPO_ROOT, "tools",
                                 "torch_staticcheck_corpus",
                                 "bad_programs.py"), "port_bad_programs")


def _jax_corpus():
    return _load(os.path.join(REPO_ROOT, "tests", "golden", "staticcheck",
                              "bad_programs.py"), "jax_bad_programs")


# ---------------------------------------------------------------------------
# The nets of both packages
# ---------------------------------------------------------------------------

def _mlp(pkg):
    data = pkg.symbol.Variable("data")
    net = pkg.symbol.FullyConnected(data=data, num_hidden=32, name="fc1")
    net = pkg.symbol.Activation(data=net, act_type="relu")
    net = pkg.symbol.FullyConnected(data=net, num_hidden=10, name="fc2")
    return pkg.symbol.SoftmaxOutput(data=net, name="softmax")


def _lm_sym(pkg):
    return pkg.models.get_symbol("transformer-lm", vocab_size=128,
                                 num_layers=2, d_model=64, heads=2,
                                 batch_size=8, seq_len=16)


FC_SHAPES = dict(data_shapes={"data": (16, 8)},
                 label_shapes={"softmax_label": (16,)})
LM_SHAPES = dict(data_shapes={"data": (8, 16)},
                 label_shapes={"softmax_label": (8, 16)})
SGD_MOM = dict(optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
ADAM = dict(optimizer="adam", optimizer_params={"learning_rate": 1e-3})
GUARDS = dict(guard=True, clip_global_norm=1.0, loss_scale="dynamic")


def _port(net, opt, shapes, **kw):
    with tmx.name.NameManager():
        sym = _mlp(tmx) if net == "fc" else _lm_sym(tmx)
    tr = ShardedTrainer(sym, device="cpu", **opt, **kw)
    tr.bind(**shapes)
    return tr


def _jax(net, opt, shapes, **kw):
    jmx.random.seed(7)
    with jmx.name.NameManager():
        sym = _mlp(jmx) if net == "fc" else _lm_sym(jmx)
    tr = JTrainer(sym, mesh=jmake_mesh({"data": len(jax.devices())}),
                  **opt, **kw)
    tr.bind(**shapes)
    return tr


def _passes(rep, prog="trainer.train"):
    hbm = rep.metrics[prog]["hbm_passes"]
    return hbm["max_reads"], hbm["max_writes"], len(hbm["buckets"])


# ---------------------------------------------------------------------------
# (1), (2): the seeded corpora
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PORT_CORPUS.PROGRAMS))
def test_corpus_program_fires_its_rules(name):
    builder, want = PORT_CORPUS.PROGRAMS[name]
    trace, kwargs = builder()
    rep = tanalysis.audit_traced(trace, f"corpus.{name}", **kwargs)
    got = {f.rule for f in rep.findings}
    assert got == set(want), rep.format_text()
    if name == "hbm_bytes_quantized":
        # the port's two-member control; the JAX one finds no reduction
        # over its one-device mesh (ROADMAP Queue 3), so nothing to hold
        rows = rep.metrics[f"corpus.{name}"]["hbm_bytes"]["collectives"]
        assert len(rows) == 2 and {r["wire_itemsize"] for r in rows} == {1}
        return
    jbuilder, jwant = _jax_corpus().PROGRAMS[name]
    traced, jkwargs = jbuilder()
    jrep = janalysis.audit_traced(traced, f"corpus.{name}", config=JCFG,
                                  **jkwargs)
    assert set(jwant) == set(want)
    assert {f.rule for f in jrep.findings} == got


def test_carry_widen_is_one_int32_to_int64_finding_in_both():
    trace, kwargs = PORT_CORPUS.PROGRAMS["carry_widen"][0]()
    rep = tanalysis.audit_traced(trace, "corpus.carry_widen", **kwargs)
    traced, jkwargs = _jax_corpus().PROGRAMS["carry_widen"][0]()
    jrep = janalysis.audit_traced(traced, "corpus.carry_widen",
                                  config=JCFG, **jkwargs)
    for r in (rep, jrep):
        carry = [f for f in r.findings if f.rule == "program.carry-widen"]
        assert len(carry) == 1
        assert "int32" in carry[0].message and "int64" in carry[0].message
    (widen,) = [f for f in rep.findings if f.rule == "program.widen"]
    assert widen.details["escapes"] and widen.details["op"] == "sum"
    assert widen.path == PORT_CORPUS.__file__


# ---------------------------------------------------------------------------
# (3) - (5): trainers
# ---------------------------------------------------------------------------

def test_fc_trainer_audits_clean_with_one_pass_fused_bucket():
    tr = _port("fc", SGD_MOM, FC_SHAPES)
    # the hopper work list is on the device from bind, not copied in at
    # the first step (a host transfer inside the step on the card)
    assert ("chunks", "cpu") in tr._chunk_plan._cache
    rep = tanalysis.assert_program_clean(tr, programs=("train", "train_acc"))
    jrep = janalysis.assert_program_clean(_jax("fc", SGD_MOM, FC_SHAPES),
                                          programs=("train", "train_acc"),
                                          config=JCFG)
    for r in (rep, jrep):
        for prog in ("trainer.train", "trainer.train_acc"):
            assert _passes(r, prog) == (1, 1, 1)
    m = rep.metrics["trainer.train"]
    assert m["kernel_notes"] == {"softmax_rows": 1, "fused_update": 1}
    assert m["backward_ops"] > 0 and m["consts_bytes"] == 0


def test_fc_unfused_update_costs_stated_passes():
    rep = tanalysis.assert_program_clean(
        _port("fc", SGD_MOM, FC_SHAPES, fused_update=False))
    jrep = janalysis.assert_program_clean(
        _jax("fc", SGD_MOM, FC_SHAPES, fused_update=False), config=JCFG)
    port, jaxs = _passes(rep)[:2], _passes(jrep)[:2]
    print(f"unfused FC passes: port {port}, JAX {jaxs}")
    assert port == (PORT_UNFUSED_FC_PASSES,) * 2 and port[0] >= 2
    assert jaxs == (JAX_UNFUSED_FC_PASSES,) * 2


def test_lm_fused_adam_is_one_pass_and_clean_in_both():
    rep = tanalysis.assert_program_clean(_port("lm", ADAM, LM_SHAPES))
    jrep = janalysis.assert_program_clean(_jax("lm", ADAM, LM_SHAPES),
                                          config=JCFG)
    assert _passes(rep)[:2] == _passes(jrep)[:2] == (1, 1)
    # the CPU's float64 square root of the plain Adam step is suppressed
    # with its reason, in place
    assert all(f.suppressed and f.suppress_reason for f in rep.findings)


def test_guardrails_cost_unfused_passes_and_keep_fused_one_pass():
    plain = tanalysis.audit_trainer(
        _port("lm", ADAM, LM_SHAPES, fused_update=False), programs=("train",))
    guarded = tanalysis.audit_trainer(
        _port("lm", ADAM, LM_SHAPES, fused_update=False, **GUARDS),
        programs=("train",))
    fused = tanalysis.audit_trainer(_port("lm", ADAM, LM_SHAPES, **GUARDS),
                                    programs=("train",))
    jplain = janalysis.audit_trainer(
        _jax("lm", ADAM, LM_SHAPES, fused_update=False), programs=("train",),
        config=JCFG)
    jguarded = janalysis.audit_trainer(
        _jax("lm", ADAM, LM_SHAPES, fused_update=False, **GUARDS),
        programs=("train",), config=JCFG)
    jfused = janalysis.audit_trainer(_jax("lm", ADAM, LM_SHAPES, **GUARDS),
                                     programs=("train",), config=JCFG)
    for p, g, f in ((plain, guarded, fused), (jplain, jguarded, jfused)):
        assert p.clean and g.clean and f.clean
        assert _passes(g)[0] > _passes(p)[0]
        assert _passes(f)[:2] == (1, 1)


# ---------------------------------------------------------------------------
# (6), (7): the optimizer step and the pytest helper
# ---------------------------------------------------------------------------

def test_optimizer_update_audits_clean_in_both():
    from mxnet_tpu.optimizer import SGD as JSGD
    from mxnet_tpu_torch.optimizer import SGD
    rep = tanalysis.audit_optimizer(SGD(momentum=0.9, learning_rate=0.1),
                                    device="cpu")
    jrep = janalysis.assert_program_clean(JSGD(momentum=0.9,
                                               learning_rate=0.1))
    tanalysis.assert_program_clean(rep)
    assert list(rep.metrics) == list(jrep.metrics) == ["optimizer.SGD"]
    assert "donation" not in rep.metrics["optimizer.SGD"]


def test_assert_program_clean_raises_naming_carry_widen():
    carry = torch.zeros((), dtype=torch.int32)
    x = torch.arange(8, dtype=torch.float32)
    trace = tprogram.record_program(
        "demo", lambda: carry + (x.to(torch.int32) == 0).sum(), "cpu",
        inputs={"carry": carry, "x": x})
    rep = tanalysis.audit_traced(trace, "demo",
                                 carry_pairs=[(0, 0, "carry")])
    with pytest.raises(AssertionError, match="program.carry-widen"):
        tanalysis.assert_program_clean(rep)


# ---------------------------------------------------------------------------
# (8), (9): auditing changes nothing
# ---------------------------------------------------------------------------

def _trainer_state(tr):
    from mxnet_tpu_torch import random as port_random
    return ([t.detach().clone() for t in tr._written_tensors()],
            dict(port_random._state), torch.random.get_rng_state())


def _same_state(a, b):
    return (all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
            and a[1] == b[1] and torch.equal(a[2], b[2]))


def test_audit_on_compile_sees_the_programs_and_changes_nothing():
    tr = _port("fc", SGD_MOM, FC_SHAPES)
    before = _trainer_state(tr)
    n0 = len(tprofiler.audit_events())
    with tanalysis.audit_on_compile() as rep:
        tr.compile(programs=("train",))
    assert list(rep.metrics) == ["trainer.train"]
    assert rep.clean, rep.format_text()
    assert rep.metrics["trainer.train"]["hbm_passes"]["per_grad"] == {
        "gradbucket:0": {"reads": 1, "writes": 1}}
    assert len(tprofiler.audit_events()) > n0
    assert _same_state(before, _trainer_state(tr))
    assert tcc.lowering_observers() == []
    jtr = _jax("fc", SGD_MOM, FC_SHAPES)
    with janalysis.audit_on_compile() as jrep:
        jtr.compile(programs=("train",))
    assert list(jrep.metrics) == list(rep.metrics)


def test_trace_program_leaves_the_trainer_and_its_next_step_as_a_twin():
    rng = np.random.RandomState(3)
    batch = {"data": rng.randn(16, 8).astype(np.float32),
             "softmax_label": rng.randint(0, 10, 16).astype(np.float32)}
    tr, twin = (_port("fc", SGD_MOM, FC_SHAPES, **GUARDS) for _ in range(2))
    before = _trainer_state(tr)
    trace, spec = tr.trace_program("train_acc")
    assert spec == {"data": ((16, 8), torch.float32),
                    "softmax_label": ((16,), torch.float32)}
    assert trace.kernel_counts() == {"softmax_rows": 1, "fused_update": 1}
    tanalysis.audit_trainer(tr)
    assert _same_state(before, _trainer_state(tr))
    heads, twin_heads = tr.step(batch), twin.step(batch)
    assert all(torch.equal(a, b) for a, b in zip(heads, twin_heads))
    assert all(torch.equal(a, b) for a, b in zip(tr._written_tensors(),
                                                 twin._written_tensors()))


# ---------------------------------------------------------------------------
# (10), (11): executors, the wire and the KV bytes
# ---------------------------------------------------------------------------

def _bn_net(pkg):
    data = pkg.symbol.Variable("data")
    net = pkg.symbol.FullyConnected(data=data, num_hidden=16, name="fc1")
    net = pkg.symbol.BatchNorm(data=net, name="bn1")
    net = pkg.symbol.Activation(data=net, act_type="relu")
    net = pkg.symbol.FullyConnected(data=net, num_hidden=4, name="fc2")
    return pkg.symbol.SoftmaxOutput(data=net, name="softmax")


def test_executor_aux_carries_audit_clean_in_both():
    with tmx.name.NameManager():
        sym = _bn_net(tmx)
    ex = sym.simple_bind(tmx.cpu(), data=(8, 6))
    aux0 = {k: v.data.clone() for k, v in ex.aux_dict.items()}
    rep = tanalysis.assert_program_clean(ex)
    with jmx.name.NameManager():
        jsym = _bn_net(jmx)
    jex = jsym.simple_bind(jmx.cpu(), data=(8, 6))
    jrep = janalysis.audit_executor(jex, config=JCFG)
    assert rep.clean and jrep.clean
    assert list(rep.metrics) == list(jrep.metrics) == [
        "executor.fwd_False", "executor.fwd_True", "executor.fb"]
    trace = tprogram.record_program(
        "fwd", ex._body_fwd(True, with_aux=True), "cpu",
        inputs=ex._program_inputs(), preserve=lambda: tcc.snapshot_state(
            ex._written()))
    pairs = tprogram._executor_aux_pairs(trace)
    assert sorted(n for _, _, n in pairs) == sorted(
        f"aux:{n}" for n in ex.aux_dict)
    assert all(torch.equal(aux0[k], ex.aux_dict[k].data) for k in aux0)


def test_int8_wire_and_fp8_kv_reads_are_one_byte():
    mesh = make_mesh({"data": 2}, [tmx.cpu(0), tmx.cpu(1)])
    rep = tanalysis.audit_trainer(
        _port("fc", SGD_MOM, FC_SHAPES, mesh=mesh, grad_compression="int8"),
        programs=("train",))
    jtr = JTrainer(_mlp(jmx), mesh=jmake_mesh({"data": 2},
                                              jax.devices()[:2]),
                   grad_compression="int8", **SGD_MOM)
    jtr.bind(**FC_SHAPES)
    jrep = janalysis.audit_trainer(jtr, programs=("train",), config=JCFG)
    for r in (rep, jrep):
        assert r.clean, r.format_text()
        rows = [x for x in r.metrics["trainer.train"]["hbm_bytes"]
                ["collectives"] if x["f32_bytes"] >= 1024]
        assert rows and {x["wire_itemsize"] for x in rows} == {1}
        assert {x["f32_bytes"] for x in rows} == {2560}
    trace, kw = PORT_CORPUS.PROGRAMS["decode_kv_quantized"][0]()
    traced, jkw = _jax_corpus().PROGRAMS["decode_kv_quantized"][0]()
    for reads in (tprogram.kv_read_rows(trace), janalysis.program
                  .kv_read_rows(traced.jaxpr)):
        assert reads and {x["itemsize"] for x in reads} == {1}


def test_engine_programs_audit_clean_with_one_byte_kv_reads():
    """The serving engine's programs on the CPU under the capture
    observers: their results are int32 (no 64-bit output escapes), an fp8
    engine's decode reads 1-byte KV, and a plain-pool engine held to 1
    byte fires ``program.hbm-bytes``."""
    from test_torch_serve import CFG, PARAMS
    from mxnet_tpu_torch.serve import Engine, EngineConfig
    for quant in ("fp8", None):
        eng = Engine(PARAMS, EngineConfig(**dict(CFG, kv_quant=quant)),
                     device="cpu")
        with tanalysis.audit_on_compile() as rep:
            eng.warmup()
        assert rep.clean, rep.format_text()
        assert len(rep.metrics) == len(eng._programs)
        decode = [p for p in rep.metrics if p.startswith("serve.decode.")]
        assert decode
        for p in decode:
            reads = rep.metrics[p]["kv_reads"]["reads"]
            assert {r["itemsize"] for r in reads} == {1 if quant else 4}
            check = tanalysis.Report()
            tprogram._check_kv_bytes(reads, 1, p, check)
            assert check.clean == bool(quant)


# ---------------------------------------------------------------------------
# (12): the recorder keeps no tensor
# ---------------------------------------------------------------------------

def test_recorder_holds_no_tensor_after_the_audit():
    x = torch.randn(64, 64)
    w = torch.randn(64, 64, requires_grad=True)
    ref_x, ref_w = weakref.ref(x), weakref.ref(w)

    def body():
        y = torch.tanh(x @ w)
        y.sum().backward()
        return y.detach(), w.grad

    trace = tprogram.record_program("weak", body, "cpu",
                                    inputs={"x": x}, state=[w])
    rep = tanalysis.audit_traced(trace, "weak")
    assert rep.metrics["weak"]["backward_ops"] > 0
    assert any(ev.backward for ev in trace.ops)
    del x, w, body
    gc.collect()
    assert ref_x() is None and ref_w() is None
    for ev in trace.events:
        assert not any(isinstance(v, torch.Tensor)
                       for v in vars(ev).values())
