"""The Module API: ``Module``, ``BucketingModule``, ``SequentialModule``,
``PythonModule`` and ``PythonLossModule`` over executor groups on one
device.

Counterpart of ``mxnet_tpu/module/``; paths through ``checkpoint/`` and
more than one context raise until their slices (ROADMAP.md).
"""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule", "DataParallelExecutorGroup"]
