"""The Module API: ``Module``, ``BucketingModule``, ``SequentialModule``,
``PythonModule`` and ``PythonLossModule`` over executor groups on one
context or several (one executor a context, the batch split over them).

Counterpart of ``mxnet_tpu/module/``; ``Module.save_checkpoint`` and
``Module.load`` write and read the legacy prefix files.
"""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "BucketingModule", "SequentialModule",
           "PythonModule", "PythonLossModule", "DataParallelExecutorGroup"]
