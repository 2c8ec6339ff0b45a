"""Device contexts: ``gpu()``, ``cpu()`` and :func:`resolve_device`.

Counterpart of ``mxnet_tpu/context.py``.  A context names a
``torch.device``.  Entry points of the port run on the card unless the
caller asks for the CPU: :func:`resolve_device` maps ``None`` to
``cuda:0`` and raises when CUDA is asked for and absent, so nothing falls
back to the CPU quietly.
"""
from __future__ import annotations

from typing import Union

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "resolve_device"]


class Context:
    """Device context ``(device_type, device_id)``; ``device_type`` is
    ``"cpu"`` or ``"gpu"``."""

    def __init__(self, device_type: str = "gpu", device_id: int = 0):
        if device_type not in ("cpu", "gpu"):
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


DeviceLike = Union[None, str, torch.device, Context]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Map ``None`` (the card), a string, a ``torch.device`` or a
    :class:`Context` to a ``torch.device``.  Raises :class:`MXNetError`
    when a CUDA device is asked for and this process has none, or has
    fewer than its index needs."""
    if device is None:
        device = torch.device("cuda", 0)
    elif isinstance(device, Context):
        device = device.torch_device
    else:
        device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise MXNetError(f"unsupported device {device}: expected cuda or cpu")
    if not torch.cuda.is_available():
        raise MXNetError(
            f"{device} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    index = 0 if device.index is None else device.index
    if index >= torch.cuda.device_count():
        raise MXNetError(f"{device} requested but only "
                         f"{torch.cuda.device_count()} CUDA device(s) present")
    return torch.device("cuda", index)
