"""Device contexts: ``gpu()``, ``cpu()``, ``with ctx:`` scopes and
:func:`resolve_device`.

Counterpart of ``mxnet_tpu/context.py``.  A context names a
``torch.device``; ``gpu`` takes the place of the JAX package's ``tpu``
(which has no counterpart here).  Entry points of the port run on the card
unless the caller asks for the CPU: :func:`resolve_device` maps ``None`` to
``cuda:0`` and raises when CUDA is asked for and absent, so nothing falls
back to the CPU quietly.

The imperative API (``ndarray``, ``random``) places arrays on
:func:`current_context`: the innermost ``with ctx:`` scope of the calling
thread, else :func:`default_ctx`, which is ``gpu(0)``.  (The JAX package's
``current_context`` defaults to ``cpu(0)`` and its arrays to the
accelerator; here both default to the card.)  Every ``cpu(i)`` is the one
host device; the id is kept, as the JAX package keeps it, so contexts
compare as they do there.
"""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "resolve_device", "current_context",
           "default_ctx", "num_devices"]


class Context:
    """Device context ``(device_type, device_id)``; ``device_type`` is
    ``"cpu"`` or ``"gpu"``.  Usable as a ``with`` block that makes it the
    thread's current context.  ``process`` tags a member of a mesh that
    spans processes (``parallel.dist``) as another process's: such a
    context names no device of this process."""

    _default_ctx = threading.local()

    devtype2mask = {"cpu": 1, "gpu": 2}
    devmask2type = {1: "cpu", 2: "gpu"}
    process: Optional[int] = None

    def __init__(self, device_type: Union[str, "Context"] = "gpu",
                 device_id: int = 0, process: Optional[int] = None):
        if isinstance(device_type, Context):
            device_type, device_id, process = (
                device_type.device_type, device_type.device_id,
                device_type.process)
        if device_type not in ("cpu", "gpu"):
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)
        self.process = None if process is None else int(process)
        self._old_ctx: Optional[Context] = None

    @property
    def device_typeid(self) -> int:
        return self.devtype2mask[self.device_type]

    @property
    def torch_device(self) -> torch.device:
        if self.process is not None:
            raise MXNetError(f"{self} is a member of process "
                             f"{self.process}, not of this process")
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id
                and self.process == other.process)

    def __hash__(self):
        return hash((self.device_type, self.device_id, self.process))

    def __repr__(self):
        where = "" if self.process is None else f"@{self.process}"
        return f"{self.device_type}({self.device_id}){where}"

    __str__ = __repr__

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        Context._default_ctx.value = self._old_ctx


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def default_ctx() -> Context:
    """The context of the port's entry points: the card, ``gpu(0)``."""
    return Context("gpu", 0)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope of this thread, else
    :func:`default_ctx`."""
    ctx = getattr(Context._default_ctx, "value", None)
    return ctx if ctx is not None else default_ctx()


def num_devices(device_type: str = "gpu") -> int:
    """Visible devices of a type: CUDA devices for ``"gpu"``, one host
    device for ``"cpu"``."""
    if device_type == "gpu":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_type == "cpu":
        return 1
    raise MXNetError(f"unknown device type {device_type!r}")


DeviceLike = Union[None, str, torch.device, Context]


def as_context(device: DeviceLike = None) -> Context:
    """A :class:`Context` for ``None`` (:func:`current_context`), a
    string, a ``torch.device`` or a context."""
    if device is None:
        return current_context()
    if isinstance(device, Context):
        return device
    device = torch.device(device)
    if device.type == "cpu":
        return cpu()
    if device.type == "cuda":
        return gpu(0 if device.index is None else device.index)
    raise MXNetError(f"unsupported device {device}: expected cuda or cpu")


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
