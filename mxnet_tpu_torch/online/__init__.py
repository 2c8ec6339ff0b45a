"""The train-to-serve deployment loop of the PyTorch port.

Counterpart of ``mxnet_tpu/online``.  This slice carries the structural
weight-compatibility predicate (:mod:`.compat`) that a hot swap of draft
weights needs; the compat stamp of checkpoint manifests and the online
post-training loop come with the checkpoint slice (ROADMAP.md).
"""
from . import compat
from .compat import CompatReport, check_compat, signature_of_params

__all__ = ["CompatReport", "check_compat", "signature_of_params", "compat"]
