"""Failure detection for the collective tier (heartbeat watchdog).

Counterpart of ``mxnet_tpu/parallel/watchdog.py``, with the same wire,
threads and telemetry.  The parameter-server tier detects worker death in
its scheduler and aborts barrier waiters (``dist_kvstore.py``).  The
collective tier (``torch.distributed`` over NCCL or gloo,
:mod:`.dist`) has no such story: a lost process leaves every peer's next
all-reduce hung until the process group's own timeout fires.  This
closes the gap the way production NCCL watchdogs do: a small side-channel
heartbeat mesh, and a hard process abort when a peer is declared dead
(a collective blocked inside NCCL or gloo cannot be interrupted from
Python; exiting the process is the only reliable unblock).

Protocol (one TCP connection per peer to the rank-0 monitor):

* every process connects to ``monitor_addr`` and sends ``MXWD1`` and its
  rank, then a beat byte every ``interval`` seconds;
* the monitor thread marks a peer dead after ``timeout`` seconds of
  silence, then broadcasts the 10-byte frame ``MXWD1 A <rank>`` to all
  surviving peers and triggers its own ``on_failure``; it answers each
  beat with ``MXWD1 K <rank>`` (the peer's round-trip gauge);
* each peer's listener thread receives the abort and calls
  ``on_failure(dead_rank)``; the default logs, waits 0.5 s and calls
  ``os._exit(70)``, so launchers and job managers observe a crashed
  process instead of a hang;
* losing the monitor connection starts a reconnect window (``timeout``
  seconds); if rank 0 never comes back the peer declares **rank 0** dead
  and fires ``on_failure(0)``.  Orderly shutdown is not a false positive
  as long as peers ``stop()`` within that window.

Imports only the standard library and the port's ``telemetry``.
"""
from __future__ import annotations

import logging
import os
import select
import socket
import struct
import threading
import time
from typing import Callable, Optional, Tuple

from .. import telemetry

__all__ = ["Watchdog"]

log = logging.getLogger(__name__)

_MAGIC = b"MXWD1"
# monitor->peer beat acknowledgement (same 10-byte frame as the abort
# broadcast so the peer's fixed-size reader stays message-aligned);
# peers that predate acks ignore unknown types by design
_ACK = b"K"


def _default_on_failure(dead_rank: int) -> None:
    log.error("watchdog: peer rank %d declared DEAD — aborting this "
              "process to unblock hung collectives", dead_rank)
    time.sleep(0.5)  # let the log line flush / tests observe side files
    os._exit(70)


class Watchdog:
    """Heartbeat failure detector over a rank-0 monitor.

    Parameters
    ----------
    rank, world : this process's rank and the process count.
    monitor_addr : (host, port) of rank 0's monitor socket.
    interval : seconds between beats.
    timeout : silence after which a peer is declared dead
        (default ``5 * interval``).
    on_failure : callback ``(dead_rank) -> None``; default logs and
        hard-exits the process with code 70 (the only reliable way out
        of a collective hung in NCCL or gloo).
    on_death : optional observer ``(dead_rank) -> None`` called BEFORE
        ``on_failure`` wherever a death verdict lands (the monitor's
        declare and every peer's abort receipt) — the membership feed:
        :func:`~.elastic.wire_watchdog` wires this to
        ``MembershipClient.report_dead`` so a watchdog verdict and a
        SIGTERM preemption notice raise the same "membership changed"
        event.  Exceptions are swallowed; the abort
        path must never be blocked by an observer.
    """

    def __init__(self, rank: int, world: int,
                 monitor_addr: Tuple[str, int],
                 interval: float = 2.0,
                 timeout: Optional[float] = None,
                 on_failure: Optional[Callable[[int], None]] = None,
                 on_death: Optional[Callable[[int], None]] = None):
        self.rank = int(rank)
        self.world = int(world)
        self.monitor_addr = (monitor_addr[0], int(monitor_addr[1]))
        self.interval = float(interval)
        self.timeout = float(timeout if timeout is not None
                             else 5 * interval)
        self.on_failure = on_failure or _default_on_failure
        self.on_death = on_death
        self._stop = threading.Event()
        self._threads = []
        self._server = None
        self._sock = None

    # ------------------------------------------------------------------

    def start(self) -> "Watchdog":
        if self.rank == 0:
            self._start_monitor()
        self._start_peer()
        return self

    def _notify_death(self, dead_rank: int) -> None:
        if self.on_death is None:
            return
        try:
            self.on_death(dead_rank)
        except Exception:
            log.exception("watchdog: on_death observer failed (ignored)")

    def stop(self) -> None:
        self._stop.set()
        for s in (self._sock, self._server):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        for t in self._threads:
            t.join(timeout=2.0)

    # ------------------------------------------------------------------
    # rank-0 monitor
    # ------------------------------------------------------------------

    def _start_monitor(self) -> None:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(self.monitor_addr)
        srv.listen(self.world + 4)
        srv.settimeout(0.5)
        self._server = srv
        self._last_seen = {}
        self._conns = {}
        self._mon_lock = threading.Lock()

        def accept_loop():
            while not self._stop.is_set():
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                conn.settimeout(self.timeout)
                try:
                    hdr = self._recv_exact(conn, len(_MAGIC) + 4)
                except OSError:
                    hdr = None
                if hdr is None or hdr[:len(_MAGIC)] != _MAGIC:
                    conn.close()
                    continue
                (peer,) = struct.unpack("<i", hdr[len(_MAGIC):])
                with self._mon_lock:
                    old = self._conns.get(peer)
                    self._conns[peer] = conn
                    self._last_seen[peer] = time.monotonic()
                if old is not None:  # peer re-registered (transient TCP
                    try:             # loss): retire the stale connection
                        old.close()
                    except OSError:
                        pass
                t = threading.Thread(target=beat_loop, args=(peer, conn),
                                     daemon=True)
                t.start()

        def beat_loop(peer, conn):
            # death is declared by HEARTBEAT SILENCE (stale_loop), not by
            # connection loss: a dropped TCP connection may be a transient
            # reset with the peer re-registering within the grace window.
            # A truly dead peer stops beating, so last_seen ages past
            # `timeout` and stale_loop fires either way.
            telemetry.name_thread(f"watchdog-beat[{peer}]")
            gap_g = telemetry.gauge("watchdog.beat_gap_seconds")
            missed_c = telemetry.counter("watchdog.missed_beats")
            ack = _MAGIC + _ACK + struct.pack("<i", self.rank)
            label = str(peer)
            while not self._stop.is_set():
                try:
                    b = conn.recv(1)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if self._stop.is_set() or not b:
                    return
                now = time.monotonic()
                with self._mon_lock:
                    if self._conns.get(peer) is conn:
                        prev = self._last_seen.get(peer)
                        self._last_seen[peer] = now
                    else:
                        prev = None
                if prev is not None:
                    gap = now - prev
                    gap_g.set(gap, peer=label)
                    if gap > 1.5 * self.interval:
                        # whole intervals of silence = beats that never
                        # arrived (per-peer health, scrape()-able long
                        # before declare-dead)
                        missed_c.inc(max(1, int(gap / self.interval) - 1),
                                     peer=label)
                # best-effort ack so the peer can measure beat RTT; a
                # full send buffer (peer not draining) just skips it —
                # the monitor thread must never block on a slow peer
                try:
                    if select.select([], [conn], [], 0)[1]:
                        conn.send(ack)
                except (OSError, ValueError):
                    pass

        def stale_loop():
            while not self._stop.is_set():
                time.sleep(self.interval)
                now = time.monotonic()
                with self._mon_lock:
                    stale = [p for p, ts in self._last_seen.items()
                             if now - ts > self.timeout]
                for p in stale:
                    self._declare_dead(p)
                    return

        for fn in (accept_loop, stale_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def _declare_dead(self, peer: int) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        log.error("watchdog monitor: rank %d missed heartbeats — "
                  "broadcasting abort", peer)
        telemetry.counter("watchdog.deaths").inc(peer=str(peer))
        # structured membership-leave event: operators and the elastic
        # layer see WHICH peer died in the same "membership" stream the
        # scheduler emits for joins/leaves/expiries (docs/elastic.md)
        telemetry.emit("membership", {"event": "leave", "member": str(peer),
                                      "reason": "watchdog-death",
                                      "rank": self.rank,
                                      "world": self.world})
        self._notify_death(peer)
        # postmortem evidence BEFORE the abort broadcast: on_failure's
        # default hard-exits the process half a second from now
        telemetry.dump_flight("watchdog-peer-death",
                              extra={"dead_rank": peer,
                                     "rank": self.rank,
                                     "world": self.world})
        msg = _MAGIC + b"A" + struct.pack("<i", peer)
        with self._mon_lock:
            conns = dict(self._conns)
        for r, c in conns.items():
            if r == peer:
                continue
            try:
                c.sendall(msg)
            except OSError:
                pass
        self.on_failure(peer)

    # ------------------------------------------------------------------
    # peer side (all ranks, incl. 0's own connection to itself)
    # ------------------------------------------------------------------

    def _connect(self, window: float):
        """Dial the monitor, retrying for ``window`` seconds; None if it
        never answers."""
        deadline = time.monotonic() + window
        while time.monotonic() < deadline and not self._stop.is_set():
            try:
                sock = socket.create_connection(self.monitor_addr,
                                                timeout=2.0)
                sock.sendall(_MAGIC + struct.pack("<i", self.rank))
                sock.settimeout(self.interval)
                return sock
            except OSError:
                time.sleep(0.2)
        return None

    def _start_peer(self) -> None:
        sock = self._connect(max(10.0, self.timeout))
        if sock is None:
            raise OSError(f"watchdog: cannot reach monitor at "
                          f"{self.monitor_addr}")
        self._sock = sock

        def serve(conn):
            """Beat/listen on one monitor connection until it drops
            ('lost') or an abort arrives ('done')."""
            telemetry.name_thread(f"watchdog-peer[{self.rank}]")
            rtt_g = telemetry.gauge("watchdog.beat_rtt_seconds")
            label = str(self.rank)
            last_beat = 0.0
            while not self._stop.is_set():
                now = time.monotonic()
                if now - last_beat >= self.interval:
                    try:
                        conn.sendall(b".")
                    except OSError:
                        return "lost"
                    last_beat = now
                try:
                    data = self._recv_exact(conn, len(_MAGIC) + 5)
                except OSError:  # incl. ConnectionError on EOF
                    return "lost"
                if data is None:
                    continue
                kind = data[len(_MAGIC):len(_MAGIC) + 1]
                if data[:len(_MAGIC)] != _MAGIC:
                    continue
                if kind == b"A":
                    (dead,) = struct.unpack("<i", data[len(_MAGIC) + 1:])
                    if not self._stop.is_set():
                        self._stop.set()
                        self._notify_death(dead)
                        self.on_failure(dead)
                    return "done"
                if kind == _ACK:
                    # monitor acked our most recent beat: send->ack
                    # round trip through the monitor's beat thread
                    rtt_g.set(time.monotonic() - last_beat, rank=label)
            return "done"

        def peer_loop():
            conn = sock
            while not self._stop.is_set():
                if serve(conn) == "done" or self._stop.is_set():
                    return
                # monitor connection lost: rank 0 may be restarting its
                # socket or may be dead.  Rank 0's own loopback peer needs
                # no guard (monitor death == own death); everyone else
                # gets a reconnect grace, then declares rank 0 failed.
                if self.rank == 0:
                    return
                conn = self._connect(self.timeout)
                if conn is None:
                    if not self._stop.is_set():
                        self._stop.set()
                        log.error(
                            "watchdog: monitor (rank 0) unreachable for "
                            "%.1fs — declaring rank 0 dead", self.timeout)
                        self.on_failure(0)
                    return
                self._sock = conn

        t = threading.Thread(target=peer_loop, daemon=True)
        t.start()
        self._threads.append(t)

    @staticmethod
    def _recv_exact(conn, n):
        """Read exactly n bytes.  Returns None on a quiet timeout (no
        bytes buffered yet), keeps buffering across timeouts once a
        message has started, and raises ConnectionError on EOF so a
        closed socket is a signal, not a silent drop or busy-spin."""
        buf = b""
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except socket.timeout:
                if buf:
                    continue
                return None
            if not chunk:
                raise ConnectionError("watchdog: connection closed"
                                      + (" mid-message" if buf else ""))
            buf += chunk
        return buf
