"""The train-to-serve deployment loop of the PyTorch port.

Counterpart of ``mxnet_tpu/online``: :mod:`.compat`, the one structural
weight-compatibility predicate of the hot swaps (with the manifest
signature and the compat stamp a publisher writes), and :mod:`.loop`,
the online post-training harness (rollouts off the live fleet, a
rejection-sampling objective, a checkpoint publish and a rolling swap
from it).
"""
from . import compat, loop
from .compat import (CompatReport, check_compat, compat_stamp,
                     signature_of_manifest, signature_of_params)
from .loop import OnlineConfig, OnlineLoop, make_rollout_trainer

__all__ = ["CompatReport", "check_compat", "compat_stamp",
           "signature_of_manifest", "signature_of_params",
           "OnlineConfig", "OnlineLoop", "make_rollout_trainer",
           "compat", "loop"]
