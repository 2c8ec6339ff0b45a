"""URI streams for save/load (dmlc-core ``Stream`` analog).

Counterpart of ``mxnet_tpu/stream.py``, with its scheme table: every
save/load path (``nd.save``/``nd.load``) goes through :func:`open_uri`,
which dispatches on the ``scheme://`` prefix:

* ``file`` (or no scheme): the local filesystem, parent directories
  created on write;
* ``memory``: an in-process store (tests, ephemeral exchange);
* ``s3`` / ``gs`` / ``hdfs``: through ``fsspec`` (``s3`` also through
  ``boto3``) when installed, else an error naming the missing package;
* anything registered with :func:`register_scheme`.
"""
from __future__ import annotations

import io
import os
from typing import Callable, Dict

from .base import MXNetError

__all__ = ["open_uri", "register_scheme", "split_scheme"]

_SCHEMES: Dict[str, Callable] = {}


def register_scheme(scheme: str, opener: Callable) -> None:
    """Register ``opener(uri, mode) -> file-like`` for ``scheme://`` URIs."""
    _SCHEMES[scheme] = opener


def split_scheme(uri: str):
    if "://" in uri:
        scheme, rest = uri.split("://", 1)
        return scheme, rest
    return "file", uri


def open_uri(uri: str, mode: str = "rb"):
    """Open a path or ``scheme://`` URI for reading or writing."""
    scheme, _ = split_scheme(uri)
    opener = _SCHEMES.get(scheme)
    if opener is None:
        raise MXNetError(
            f"no stream handler for scheme {scheme!r} "
            f"(registered: {sorted(_SCHEMES)}); add one with "
            "mxnet_tpu_torch.stream.register_scheme")
    return opener(uri, mode)


def _open_file(uri: str, mode: str):
    _, path = split_scheme(uri)
    if "w" in mode or "a" in mode:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    return open(path, mode)


register_scheme("file", _open_file)


_MEMORY: Dict[str, bytes] = {}


class _MemoryWriter(io.BytesIO):
    def __init__(self, key):
        super().__init__()
        self._key = key

    def close(self):
        _MEMORY[self._key] = self.getvalue()
        super().close()


def _open_memory(uri: str, mode: str):
    _, key = split_scheme(uri)
    if "w" in mode:
        return (io.TextIOWrapper(_MemoryWriter(key))
                if "b" not in mode else _MemoryWriter(key))
    if key not in _MEMORY:
        raise MXNetError(f"memory://{key} does not exist")
    buf = io.BytesIO(_MEMORY[key])
    return io.TextIOWrapper(buf) if "b" not in mode else buf


register_scheme("memory", _open_memory)


def _open_remote(uri: str, mode: str):
    scheme, rest = split_scheme(uri)
    try:
        import fsspec
        return fsspec.open(uri, mode).open()
    except ImportError:
        pass
    if scheme == "s3":  # boto3 speaks only AWS S3
        try:
            import boto3
        except ImportError:
            raise MXNetError(
                "s3:// streams need the 'fsspec' or 'boto3' package; "
                "install one or register_scheme a custom opener") from None
        bucket, _, key = rest.partition("/")
        s3 = boto3.client("s3")
        if "w" in mode:
            class _S3Writer(io.BytesIO):
                def close(self_inner):
                    s3.put_object(Bucket=bucket, Key=key,
                                  Body=self_inner.getvalue())
                    io.BytesIO.close(self_inner)
            w = _S3Writer()
            return io.TextIOWrapper(w) if "b" not in mode else w
        body = s3.get_object(Bucket=bucket, Key=key)["Body"].read()
        buf = io.BytesIO(body)
        return io.TextIOWrapper(buf) if "b" not in mode else buf
    raise MXNetError(
        f"{scheme}:// streams need the 'fsspec' package; install it or "
        "register_scheme a custom opener")


register_scheme("s3", _open_remote)
register_scheme("gs", _open_remote)
register_scheme("hdfs", _open_remote)
