"""Import hygiene of the PyTorch port: ``mxnet_tpu_torch`` and
``chip_smoke.py`` import torch, never jax and nothing of ``mxnet_tpu``.

A subprocess blocks ``jax`` (``sys.modules['jax'] = None`` makes any
import of it fail) and imports the port, its serve package, the training
modules (symbol, models.resnet, models.transformer_lm, ops.fused_update,
ops.attention_ops, parallel.trainer, parallel.flash_attention,
parallel.ring_attention, parallel.mesh) and ``chip_smoke``; a source scan checks every file of the port and the
script for such imports.
"""
import os
import re
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
import mxnet_tpu_torch.symbol
import mxnet_tpu_torch.models.resnet
import mxnet_tpu_torch.ops.fused_update
import mxnet_tpu_torch.ops.nn_ops
import mxnet_tpu_torch.parallel.trainer
import mxnet_tpu_torch.parallel.flash_attention
import mxnet_tpu_torch.parallel.ring_attention
import mxnet_tpu_torch.parallel.mesh
import mxnet_tpu_torch.ops.attention_ops
from mxnet_tpu_torch.models import transformer_lm
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch import (attribute, graph_eval, initializer, name,
                             ndarray, optimizer, resilience)
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
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [(f.relative_to(ROOT).as_posix(), m)
                 for f in files for m in _imported_modules(f.read_text())
                 if m in ("jax", "jaxlib", "mxnet_tpu")]
    assert offenders == []
