"""Checkpoints: atomic snapshots, full trainer state, preemption-safe
auto-resume.

Counterpart of ``mxnet_tpu/checkpoint/``, with the same on-disk layout
(``step-%08d/manifest.json`` and its shard files), so a checkpoint either
package writes loads in the other.

Quick start (preemptible training script)::

    import mxnet_tpu_torch as mx

    manager = mx.checkpoint.CheckpointManager(
        "/ckpt/run1", save_interval_steps=500, keep_last=3)
    trainer.bind(...)
    trainer.restore_or_initialize(manager)       # no-op on first launch
    manager.install_preemption_hook(
        lambda: trainer.save_state(manager, blocking=True))
    trainer.fit(train_iter, checkpoint_manager=manager, ...)
"""
from . import layout, reader, writer
from .layout import (FORMAT_VERSION, MANIFEST_NAME, committed_steps,
                     read_manifest)
from .manager import CheckpointManager
from .reader import (load_arrays, load_legacy_params, read_array,
                     restore_array, verify_checkpoint)
from .writer import (AsyncCheckpointWriter, gc_checkpoints, snapshot,
                     sweep_staging, write_checkpoint)

__all__ = [
    "CheckpointManager", "FORMAT_VERSION", "MANIFEST_NAME",
    "AsyncCheckpointWriter", "snapshot", "write_checkpoint",
    "gc_checkpoints", "sweep_staging", "read_array", "restore_array",
    "load_arrays", "verify_checkpoint", "load_legacy_params",
    "committed_steps", "read_manifest", "layout", "reader", "writer",
]
