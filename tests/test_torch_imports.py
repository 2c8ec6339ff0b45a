"""Import hygiene of the PyTorch port: ``mxnet_tpu_torch`` and
``chip_smoke.py`` import torch, never jax and nothing of ``mxnet_tpu``.

A subprocess blocks ``jax`` (``sys.modules['jax'] = None`` makes any
import of it fail) and imports the port, its serve package (speculate,
the router, the autoscaler and the traffic simulator included), the
telemetry plane, ``chaos`` and ``online.compat``, the training
modules (symbol, models.resnet, models.transformer_lm, ops.fused_update,
ops.attention_ops, parallel.trainer, parallel.flash_attention,
parallel.ring_attention, parallel.mesh, quant), the imperative and
executor modules (context, stream, ndarray, random, executor, operator,
rtc, models.mnist), the training loop's modules (io, metric,
lr_scheduler, callback, model), the zoo and the legacy API
(models.classic, models.inception, executor_manager, module, monitor),
the long-run and durability modules (checkpoint and its layout, reader,
writer and manager, predictor, online.loop, quant's fp8 product), the
data-parallel modules (kvstore, parallel.mesh and parallel.collectives),
the input records, the last three ops and the deployment predictor
(recordio, image_io, ops.ctc, ops.detection_ops, predictor's Predictor
and export), tensor and model parallelism (parallel.tensor_parallel,
ShardingRules, megatron_rules, the axis collectives, the executor's
cross-device copy), pipelines (parallel.pipeline, parallel.pipeline_trainer,
parallel.pipeline_spmd; none of them touches the card at import), the
multi-process tier (parallel.dist, parallel.dist_kvstore,
parallel.launch, the process bridge of the member meetings,
parallel.watchdog, parallel.elastic), the analysis tooling (analysis and
its findings, program, concurrency, schedules and source modules,
visualization, also as ``viz``) and ``chip_smoke``; a source scan checks
every file of the port, the script, ``tools/torch_launch.py``,
``tools/torch_staticcheck.py`` and its corpus (the program corpus
``bad_programs.py`` included), ``tools/torch_compile_cache_inspect.py``,
``tools/torch_conv_probe.py``, ``tools/torch_im2rec.py``,
``tools/torch_ckpt_inspect.py`` and the serving code that the C predict
API embeds (``csrc/c_predict_serve.py``) for such imports.  ``chip_smoke.py --dist-worker`` (phase 23's child
program) runs a ``dist_async`` cluster on the CPU with ``jax``,
``jaxlib`` and ``mxnet_tpu`` unimportable in every child, and
``tools/torch_launch.py`` parses its arguments, and
``tools/torch_staticcheck.py lint`` lints the port clean, with them
unimportable.
"""
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, {root!r})
import mxnet_tpu_torch
import mxnet_tpu_torch.serve
from mxnet_tpu_torch.serve import Engine, EngineConfig, ServeError, kvcache
import mxnet_tpu_torch.serve.speculate
import mxnet_tpu_torch.serve.router
import mxnet_tpu_torch.serve.autoscale
import mxnet_tpu_torch.serve.traffic
from mxnet_tpu_torch.serve import (Router, RouterConfig, Autoscaler,
                                   AutoscaleConfig, LoadGen, TraceConfig,
                                   generate_trace)
import mxnet_tpu_torch.telemetry
import mxnet_tpu_torch.chaos
from mxnet_tpu_torch.resilience import Heartbeat
import mxnet_tpu_torch.online.compat
import mxnet_tpu_torch.symbol
import mxnet_tpu_torch.models.resnet
import mxnet_tpu_torch.ops.fused_update
import mxnet_tpu_torch.ops.nn_ops
import mxnet_tpu_torch.ops.conv_backward
import mxnet_tpu_torch.parallel.trainer
import mxnet_tpu_torch.parallel.flash_attention
import mxnet_tpu_torch.parallel.ring_attention
import mxnet_tpu_torch.parallel.mesh
import mxnet_tpu_torch.ops.attention_ops
from mxnet_tpu_torch.models import transformer_lm
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch import (attribute, graph_eval, initializer, name,
                             ndarray, optimizer, quant, resilience)
from mxnet_tpu_torch import (context, executor, operator, random, rtc,
                             stream)
from mxnet_tpu_torch.models import mnist
from mxnet_tpu_torch import callback, io, lr_scheduler, metric, model
from mxnet_tpu_torch import executor_manager, module, monitor
from mxnet_tpu_torch.models import classic, inception
from mxnet_tpu_torch.module import (BucketingModule, Module,
                                    PythonLossModule, SequentialModule)
import mxnet_tpu_torch.checkpoint
from mxnet_tpu_torch.checkpoint import (CheckpointManager, layout, reader,
                                        writer)
import mxnet_tpu_torch.predictor
import mxnet_tpu_torch.online.loop
from mxnet_tpu_torch.online import OnlineLoop, compat_stamp
from mxnet_tpu_torch.quant import block_dot, fp8_linear
from mxnet_tpu_torch import compile_cache, profiler
from mxnet_tpu_torch import kvstore
from mxnet_tpu_torch.parallel import (Mesh, NamedSharding, PartitionSpec,
                                      allreduce_sum, collectives,
                                      data_parallel_mesh, make_mesh)
from mxnet_tpu_torch.parallel.collectives import (count_collectives,
                                                  psum_compressed)
assert mxnet_tpu_torch.kvstore is kvstore
import mxnet_tpu_torch.parallel.tensor_parallel
from mxnet_tpu_torch.parallel import (ShardingRules, megatron_rules,
                                      tensor_parallel)
from mxnet_tpu_torch.parallel.collectives import (all_gather, over_axis,
                                                  reduce_scatter)
from mxnet_tpu_torch.parallel.mesh import axis_groups
from mxnet_tpu_torch.ops.nn_ops import cross_device_copy
import mxnet_tpu_torch.parallel.pipeline
import mxnet_tpu_torch.parallel.pipeline_spmd
import mxnet_tpu_torch.parallel.pipeline_trainer
from mxnet_tpu_torch.parallel import (PipelineTrainer, SpmdPipelineTrainer,
                                      pipeline_apply)
from mxnet_tpu_torch.parallel.pipeline_spmd import schedule_1f1b
import mxnet_tpu_torch.parallel.dist
import mxnet_tpu_torch.parallel.dist_kvstore
import mxnet_tpu_torch.parallel.launch
from mxnet_tpu_torch.parallel import dist, dist_kvstore, launch
from mxnet_tpu_torch.parallel.dist_kvstore import (DistKVStore,
                                                   MembershipClient,
                                                   run_scheduler, run_server)
from mxnet_tpu_torch.parallel.launch import launch_local, launch_ssh, submit
from mxnet_tpu_torch.parallel.members import ProcessBridge, TokenChain
from mxnet_tpu_torch.parallel.process_mesh import ProcessLayout
from mxnet_tpu_torch.parallel.collectives import allreduce_processes
import mxnet_tpu_torch.parallel.watchdog
import mxnet_tpu_torch.parallel.elastic
from mxnet_tpu_torch.parallel import (ElasticTrainer, default_mesh_size,
                                      elastic, pow2_floor, watchdog,
                                      wire_watchdog)
from mxnet_tpu_torch.parallel.watchdog import Watchdog
import torch
assert not torch.cuda.is_initialized()
from mxnet_tpu_torch import AttrScope
from mxnet_tpu_torch import image_io, recordio
from mxnet_tpu_torch.ops import ctc, detection_ops
from mxnet_tpu_torch.predictor import (ExportedPredictor, Predictor, create,
                                       export_model, load_exported,
                                       load_ndarray_file)
assert mxnet_tpu_torch.recordio is recordio
assert mxnet_tpu_torch.ImageRecordIter is image_io.ImageRecordIter
from mxnet_tpu_torch.compile_cache import CapturedProgram, ProgramCache
from mxnet_tpu_torch import analysis, visualization
from mxnet_tpu_torch.analysis import (concurrency, findings, program,
                                      schedules, source)
from mxnet_tpu_torch.analysis.program import (ProgramTrace, audit_trainer,
                                              note_kernel, record_program)
from mxnet_tpu_torch.analysis import (Finding, Report, RULES,
                                      ScheduleFuzzer, audit_threads,
                                      lint_paths, run_schedules)
from mxnet_tpu_torch.visualization import plot_network, print_summary
assert mxnet_tpu_torch.viz is visualization
assert mxnet_tpu_torch.visualization is visualization
assert mxnet_tpu_torch.analysis is analysis
assert mxnet_tpu_torch.profiler is profiler
assert mxnet_tpu_torch.io is io and mxnet_tpu_torch.metric is metric
assert mxnet_tpu_torch.lr_scheduler is lr_scheduler
assert mxnet_tpu_torch.callback is callback
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")
             and sys.modules[m] is not None)
print("LOADED", bad)
"""


def test_port_imports_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


_IMPORT = re.compile(
    r"^\s*(?:from\s+(\S+)\s+import|import\s+([\w., ]+))", re.MULTILINE)


def _imported_modules(text):
    for frm, imp in _IMPORT.findall(text):
        names = [frm] if frm else [n.strip().split(" as ")[0]
                                   for n in imp.split(",")]
        for n in names:
            yield n.split(".")[0]


def test_no_jax_or_reference_package_in_port_sources():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_launch.py",
              ROOT / "tools" / "torch_staticcheck.py",
              ROOT / "tools" / "torch_compile_cache_inspect.py",
              ROOT / "tools" / "torch_conv_probe.py",
              ROOT / "tools" / "torch_im2rec.py",
              ROOT / "tools" / "torch_ckpt_inspect.py"]
    files += sorted((ROOT / "tools" / "torch_staticcheck_corpus")
                    .glob("*.py"))
    assert ROOT / "tools" / "torch_staticcheck_corpus" / "bad_programs.py" \
        in files
    # the serving code the C predict API embeds
    assert ROOT / "mxnet_tpu_torch" / "csrc" / "c_predict_serve.py" in files
    assert len(files) > 10
    offenders = [(f.relative_to(ROOT).as_posix(), m)
                 for f in files for m in _imported_modules(f.read_text())
                 if m in ("jax", "jaxlib", "mxnet_tpu")]
    assert offenders == []


def test_smoke_dist_worker_runs_without_jax(tmp_path, monkeypatch):
    """Phase 23's child program, ``chip_smoke.py --dist-worker kv-async``,
    as every role of a ``launch_local`` cluster (1 scheduler, 2 servers,
    2 workers) on the CPU, with a path entry that makes ``jax``,
    ``jaxlib`` and ``mxnet_tpu`` raise on import: both workers pull the
    closed form and report no such module loaded."""
    sys.path.insert(0, str(ROOT))
    try:
        from mxnet_tpu_torch.parallel.launch import launch_local
    finally:
        sys.path.remove(str(ROOT))
    block = tmp_path / "block"
    block.mkdir()
    for name in ("jax", "jaxlib", "mxnet_tpu"):
        (block / f"{name}.py").write_text(
            "raise ImportError('blocked for this test')\n")
    out = tmp_path / "out"
    out.mkdir()
    plan = {"device": "cpu", "agg": {"small": [3, 3], "big": [40, 40],
                                     "rate": 2, "repeat": 3}}
    (out / "plan.json").write_text(json.dumps(plan))
    monkeypatch.setenv("PYTHONPATH", f"{block}{os.pathsep}{ROOT}")
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "4096")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    codes = launch_local([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--dist-worker", "kv-async", str(out)],
                         num_workers=2, num_servers=2, root_port=port,
                         timeout=120, return_codes=True)
    logs = {p.name: p.read_text() for p in out.glob("*.log")}
    assert codes == [0, 0], logs
    results = [json.loads(line[4:]) for text in logs.values()
               for line in text.splitlines() if line.startswith("P23 ")]
    assert sorted(r["rank"] for r in results) == [0, 1], logs
    for r in results:
        assert r["foreign"] == []
        assert r["aggregate"] == {"closed_form": 19.0, "pushes_a_key": 6}
    assert len(logs) == 5 and all(t.rstrip().endswith("exit code 0")
                                  for t in logs.values()), logs


def test_launcher_cli_imports_the_port_only(tmp_path):
    """``tools/torch_launch.py --help`` with ``jax``, ``jaxlib`` and
    ``mxnet_tpu`` made unimportable: it imports the port and exits 0."""
    block = tmp_path / "block"
    block.mkdir()
    for name in ("jax", "jaxlib", "mxnet_tpu"):
        (block / f"{name}.py").write_text(
            "raise ImportError('blocked for this test')\n")
    env = dict(os.environ, PYTHONPATH=str(block))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_launch.py"), "--help"],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "--num-workers" in proc.stdout


def test_staticcheck_cli_imports_the_port_only(tmp_path):
    """``tools/torch_staticcheck.py lint --json`` with ``jax``, ``jaxlib``
    and ``mxnet_tpu`` made unimportable: it lints the port clean and
    exits 0."""
    block = tmp_path / "block"
    block.mkdir()
    for name in ("jax", "jaxlib", "mxnet_tpu"):
        (block / f"{name}.py").write_text(
            "raise ImportError('blocked for this test')\n")
    env = dict(os.environ, PYTHONPATH=str(block))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_staticcheck.py"),
         "lint", "--json"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr
    out = json.loads(proc.stdout)
    assert out["ok"] and out["command"] == "lint"
