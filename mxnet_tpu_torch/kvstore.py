"""KVStore: key-value parameter synchronization within one process.

Counterpart of ``mxnet_tpu/kvstore.py`` for the local kinds (``local``,
``local_update_cpu``, ``local_allreduce_cpu``, ``device``,
``local_allreduce_device``).  Pushed values are snapshotted (a clone, as
the JAX package's immutable arrays are) and queued; once ~``bucket_bytes``
are pending, and on every ``pull``/``barrier``, the queue is reduced
through the bucketed collectives of :mod:`.parallel.collectives` (values
on distinct contexts: buckets in priority order, optionally compressed;
co-resident values: the tree sum), then handed to the updater in push
order, or kept in a merge buffer that ``pull`` returns when there is no
updater.  ``create("dist" | "dist_sync" | "dist_async")`` gives the
parameter server's worker store (:mod:`.parallel.dist_kvstore`).

``save_optimizer_states`` writes the JAX package's file: a pickle of
``{"optimizer": <pickled optimizer>, "states": <host states>}``, the
optimizer pickled under the class path the JAX package uses, so either
package loads the other's file (:func:`dumps_optimizer`,
:func:`loads_optimizer`).
"""
from __future__ import annotations

import io
import pickle
import sys
from typing import Any, Callable, Dict, List, Optional

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create", "dumps_optimizer", "loads_optimizer"]

# the class path the JAX package's optimizer pickles carry; the port's
# classes of the same names load in their place
_JAX_PACKAGE = "mxnet_tpu"
_PORT_PACKAGE = __name__.rsplit(".", 1)[0]


def _key_list(key) -> List:
    return list(key) if isinstance(key, (list, tuple)) else [key]


def _value_list(key, value):
    """Normalize (key, value) to (keys, list-of-lists-of-NDArray)."""
    keys = _key_list(key)
    if isinstance(value, NDArray):
        value = [[value]]
    elif isinstance(value, (list, tuple)) and value \
            and isinstance(value[0], NDArray):
        if len(keys) == 1:
            value = [list(value)]
        else:
            value = [[v] for v in value]
    elif isinstance(value, (list, tuple)):
        value = [list(v) if isinstance(v, (list, tuple)) else [v]
                 for v in value]
    if len(keys) != len(value):
        raise MXNetError(f"kvstore: {len(keys)} keys but {len(value)} "
                         "value groups")
    return keys, value


def dumps_optimizer(optimizer) -> bytes:
    """Pickle an optimizer of the port under the JAX package's class path
    (``mxnet_tpu.optimizer.<Name>`` with the same attribute dict): the
    bytes the JAX package writes for its optimizer of that name."""
    cls = type(optimizer)
    module = cls.__module__
    if module.startswith(_PORT_PACKAGE + "."):
        module = _JAX_PACKAGE + module[len(_PORT_PACKAGE):]
    state = pickle.dumps(optimizer.__dict__, protocol=2)
    # GLOBAL module name, EMPTY_TUPLE, NEWOBJ, <state>, BUILD, STOP: the
    # state's own PROTO header and STOP are cut out
    return (b"\x80\x02c" + module.encode() + b"\n" + cls.__qualname__.encode()
            + b"\n)\x81" + state[2:-1] + b"b.")


class _PortUnpickler(pickle.Unpickler):
    """Loads the JAX package's classes as the port's of the same name."""

    def find_class(self, module, name):
        if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
            module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
        return super().find_class(module, name)


def loads_optimizer(data: bytes):
    """Unpickle ``data`` (an optimizer from :func:`dumps_optimizer`'s
    bytes or the JAX package's, or a file holding one), the JAX package's
    classes loading as the port's."""
    return _PortUnpickler(io.BytesIO(data)).load()


class KVStore:
    """Local single-process store (the reference's ``KVStoreLocal``).

    ``push`` is deferred: pushed groups queue with their priority and are
    reduced through fused flat buckets, once ~``bucket_bytes`` are pending
    (so early buckets reduce while later gradients are still being
    produced) and fully on ``pull``/``barrier``.  ``compression='int8' |
    'bf16' | 'fp8'`` selects a quantized wire format for values on
    distinct contexts; off by default.
    """

    def __init__(self, kind: str = "local",
                 compression: Optional[str] = None,
                 bucket_bytes: Optional[int] = None):
        from .parallel.collectives import (DEFAULT_BUCKET_BYTES,
                                           check_compression)
        self._kind = kind
        self._store: Dict[Any, NDArray] = {}
        # per-key merge buffer of the no-updater (allreduce) mode: pull
        # returns the last merged push, never the init value
        self._merge_buf: Dict[Any, NDArray] = {}
        self._updater: Optional[Callable] = None
        self._optimizer_blob: Optional[bytes] = None
        self._compression = check_compression(compression)
        self._bucket_bytes = int(bucket_bytes) if bucket_bytes \
            else DEFAULT_BUCKET_BYTES
        # deferred pushes: (priority, key, [NDArray snapshots]) in order
        self._pending: List = []
        self._pending_bytes = 0

    @property
    def compression(self) -> Optional[str]:
        return self._compression

    @property
    def type(self) -> str:
        return self._kind

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    # ------------------------------------------------------------------

    def init(self, key, value) -> None:
        keys, values = _value_list(key, value)
        for k, vgroup in zip(keys, values):
            if k in self._store:
                raise MXNetError(f"kvstore: key {k} already initialized")
            self._store[k] = vgroup[0].copy()

    def push(self, key, value, priority: int = 0) -> None:
        """Queue values for aggregation.  Each value is snapshotted now,
        so a later in-place write by the caller cannot leak into the
        merge."""
        keys, values = _value_list(key, value)
        for k, vgroup in zip(keys, values):
            if k not in self._store:
                raise MXNetError(f"kvstore: key {k} not initialized")
            snaps = [v.copy() for v in vgroup]
            self._pending.append((priority, k, snaps))
            self._pending_bytes += (snaps[0].data.numel()
                                    * snaps[0].data.element_size())
            if self._pending_bytes >= self._bucket_bytes:
                # a bucket's worth is ready: reduce it now
                self._flush()

    def _flush(self) -> None:
        """Reduce every pending push (bucketed, in priority order) and
        apply the updater or fill the merge buffers in push order."""
        if not self._pending:
            return
        from . import telemetry
        from .parallel.collectives import allreduce_sum
        with telemetry.span("collective.flush", pending=len(self._pending),
                            bytes=self._pending_bytes):
            pending, self._pending, self._pending_bytes = \
                self._pending, [], 0
            multi = [i for i, (_, _, vals) in enumerate(pending)
                     if len(vals) > 1]
            merged_by_i = {}
            if multi:
                reduced = allreduce_sum(
                    [pending[i][2] for i in multi],
                    priorities=[pending[i][0] for i in multi],
                    bucket_bytes=self._bucket_bytes,
                    compression=self._compression)
                for i, r in zip(multi, reduced):
                    merged_by_i[i] = r[0]
            for i, (_, k, vals) in enumerate(pending):
                merged = merged_by_i.get(i, vals[0])
                store = self._store[k]
                merged_nd = NDArray(merged.data.to(store.data.device),
                                    ctx=store.context)
                if self._updater is not None:
                    self._updater(k, merged_nd, store)
                else:
                    self._merge_buf[k] = merged_nd

    def pull(self, key, out=None, priority: int = 0) -> None:
        self._flush()
        keys, outs = _value_list(key, out)
        for k, ogroup in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"kvstore: key {k} not initialized")
            if self._updater is None and k in self._merge_buf:
                src = self._merge_buf[k]
            else:
                src = self._store[k]
            for o in ogroup:
                src.copyto(o)

    # ------------------------------------------------------------------

    def set_updater(self, updater: Callable) -> None:
        """``updater(key, recv, local)``."""
        self._updater = updater

    def set_optimizer(self, optimizer) -> None:
        """Use an optimizer for updates: installs ``get_updater`` (the
        reference pickles it to its servers in the dist kinds)."""
        from .optimizer import get_updater
        self._optimizer_blob = dumps_optimizer(optimizer)
        self.set_updater(get_updater(optimizer))

    def barrier(self) -> None:
        self._flush()

    def send_command_to_servers(self, head: int, body: str) -> None:
        pass

    def save_optimizer_states(self, fname: str) -> None:
        """Write the optimizer and its updater's per-key states (the
        moments survive a save and load)."""
        if self._optimizer_blob is None:
            raise MXNetError("no optimizer set on kvstore")
        self._flush()
        from .optimizer import states_to_host
        states = getattr(self._updater, "states", None) or {}
        blob = {"optimizer": self._optimizer_blob,
                "states": states_to_host(states)}
        with open(fname, "wb") as f:
            f.write(pickle.dumps(blob))

    def load_optimizer_states(self, fname: str) -> None:
        from .optimizer import states_from_host
        with open(fname, "rb") as f:
            blob = loads_optimizer(f.read())
        if not (isinstance(blob, dict) and "optimizer" in blob):
            # the older format: a bare pickled optimizer
            self.set_optimizer(blob)
            return
        self.set_optimizer(loads_optimizer(blob["optimizer"]))

        def ctx_for_key(k):
            arr = self._store.get(k)
            return arr.context if arr is not None else None

        states = getattr(self._updater, "states", None)
        if states is not None:
            states.clear()
            states.update(states_from_host(blob["states"], ctx_for_key))


_LOCAL_KINDS = ("local", "local_update_cpu", "local_allreduce_cpu",
                "device", "local_allreduce_device")


def create(name: str = "local", compression: Optional[str] = None,
           bucket_bytes: Optional[int] = None) -> KVStore:
    """A store by kind.  ``compression``/``bucket_bytes`` configure the
    reduction (quantized wire, bucket size); both default off / ~4 MiB.

    For the ``dist*`` kinds (:mod:`.parallel.dist_kvstore`), a process
    launched in the ``scheduler`` or ``server`` role
    (:mod:`.parallel.launch`) runs its blocking loop and exits, as the
    reference's ``kvstore_server._init_kvstore_server_module`` does; a
    worker gets a ``DistKVStore``, which raises without a launched
    cluster."""
    if not isinstance(name, str):
        raise MXNetError("name must be a string")
    if name in _LOCAL_KINDS:
        return KVStore(name, compression=compression,
                       bucket_bytes=bucket_bytes)
    if name.startswith("dist"):
        from .parallel import dist_kvstore as dkv
        cfg = dkv.role_from_env()
        role = cfg.get("role", "worker")
        if role == "scheduler":
            dkv.run_scheduler(cfg)
            sys.exit(0)
        if role == "server":
            dkv.run_server(cfg)
            sys.exit(0)
        return dkv.DistKVStore(name, compression=compression,
                               bucket_bytes=bucket_bytes)
    raise MXNetError(f"unknown kvstore type {name}; known: "
                     f"{_LOCAL_KINDS + ('dist', 'dist_sync', 'dist_async')}")
