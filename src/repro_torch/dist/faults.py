"""Fault-injection TCP proxy: the network weather machine for chaos tests.

:class:`ChaosProxy` sits between
:class:`~repro_torch.dist.rpc.QueueClient` and a
:class:`~repro_torch.dist.rpc.QueueServer` (or any TCP pair) and mangles
traffic in the ways real networks and dying hosts do:

* **drop** — a forwarded chunk silently vanishes (the receiver sees a
  desynchronized stream and must tear the connection down);
* **delay** — a chunk stalls for ``delay_s`` before moving on (latency
  spikes, head-of-line blocking);
* **duplicate** — a chunk is forwarded twice (the duplicated bytes corrupt
  the framing exactly like a misbehaving middlebox would);
* **truncate** — half a chunk is forwarded and then *both* sockets are torn
  down: the close-mid-frame case, what a host dying mid-``sendall`` looks
  like from the other end;
* **partition** — :meth:`partition` freezes every pump (bytes neither flow
  nor error) until the partition heals: the connection is alive but the
  network is gone, which is precisely the shape lease reaping exists for.

Faults fire per forwarded chunk from a deterministic per-pump
``random.Random`` seeded by ``seed ^ connection-index ^ direction``, so a
failing chaos run replays byte-for-byte. All probabilities default to 0 —
a fresh proxy is a transparent passthrough; tests opt into exactly the
weather they want. Counters (``stats()``) record what actually fired, so a
"chaos" run that never injected anything fails loudly instead of greenly.

The proxy is protocol-blind on purpose: it corrupts *transport*, never
*semantics*. Whether the system above survives is the queue's epoch fencing
and the client's reconnect discipline — which is what the invariant harness
asserts.
"""
from __future__ import annotations

import random
import socket
import threading
import time
from typing import Dict, Optional, Tuple

_CHUNK = 4096


class ChaosProxy:
    """A TCP proxy that injects transport faults between dial and upstream.

    ``upstream`` is the real server's ``(host, port)``. The proxy listens on
    ``(host, port=0)`` (loopback, ephemeral) — dial :attr:`address` instead
    of the upstream and every connection is pumped through the fault engine.
    Use as a context manager or call :meth:`stop` explicitly.
    """

    def __init__(self, upstream: Tuple[str, int], *, seed: int = 0,
                 drop_rate: float = 0.0, delay_rate: float = 0.0,
                 delay_s: float = 0.02, dup_rate: float = 0.0,
                 truncate_rate: float = 0.0, host: str = "127.0.0.1"):
        self.upstream = tuple(upstream)
        self.seed = int(seed)
        self.drop_rate = float(drop_rate)
        self.delay_rate = float(delay_rate)
        self.delay_s = float(delay_s)
        self.dup_rate = float(dup_rate)
        self.truncate_rate = float(truncate_rate)
        self._listener = socket.create_server((host, 0))
        self._listener.settimeout(0.2)
        self._addr = self._listener.getsockname()
        self._stopped = threading.Event()
        # set = traffic flows; cleared = partitioned (pumps freeze)
        self._open = threading.Event()
        self._open.set()
        self._lock = threading.Lock()
        self._conn_index = 0
        self._counters: Dict[str, int] = {
            "conns": 0, "chunks": 0, "dropped": 0, "delayed": 0,
            "duplicated": 0, "truncated": 0, "partition_stalls": 0,
        }
        self._threads = []
        self._accept_thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ChaosProxy":
        t = threading.Thread(target=self._accept_loop,
                             name="chaos-proxy-accept", daemon=True)
        t.start()
        self._accept_thread = t
        return self

    def stop(self) -> None:
        """Idempotent: stop accepting, tear down every live pump."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        self._open.set()                 # unfreeze pumps so they can exit
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=2.0)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def address(self) -> Tuple[str, int]:
        """What clients dial instead of the upstream."""
        return self._addr

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    # -- partition ----------------------------------------------------------
    def partition(self, on: bool) -> None:
        """``on=True`` freezes every pump mid-stream (no bytes, no errors —
        the network is simply *gone*); ``on=False`` heals it and buffered
        bytes resume. New connections accepted during a partition stall the
        same way, before their upstream dial."""
        if on:
            self._open.clear()
        else:
            self._open.set()

    def _await_open(self) -> bool:
        """Block while partitioned. Returns False if the proxy stopped."""
        if not self._open.is_set():
            self._bump("partition_stalls")
            while not self._open.wait(timeout=0.1):
                if self._stopped.is_set():
                    return False
        return not self._stopped.is_set()

    # -- pumps --------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return                   # listener closed by stop()
            with self._lock:
                idx = self._conn_index
                self._conn_index += 1
                self._counters["conns"] += 1
            t = threading.Thread(target=self._serve_conn, args=(conn, idx),
                                 name=f"chaos-proxy-conn-{idx}", daemon=True)
            with self._lock:
                self._threads.append(t)
            t.start()

    def _serve_conn(self, client: socket.socket, idx: int) -> None:
        if not self._await_open():
            client.close()
            return
        try:
            upstream = socket.create_connection(self.upstream, timeout=5.0)
        except OSError:
            client.close()               # upstream down (mid-restart): RST
            return
        dead = threading.Event()         # either pump's death kills both
        pumps = [
            threading.Thread(
                target=self._pump, name=f"chaos-pump-{idx}-up", daemon=True,
                args=(client, upstream, random.Random(self.seed ^ (idx << 1)),
                      dead)),
            threading.Thread(
                target=self._pump, name=f"chaos-pump-{idx}-down", daemon=True,
                args=(upstream, client,
                      random.Random(self.seed ^ (idx << 1) ^ 1), dead)),
        ]
        for p in pumps:
            p.start()
        for p in pumps:
            p.join()
        for s in (client, upstream):
            try:
                s.close()
            except OSError:
                pass

    def _pump(self, src: socket.socket, dst: socket.socket,
              rng: random.Random, dead: threading.Event) -> None:
        try:
            while not self._stopped.is_set() and not dead.is_set():
                src.settimeout(0.2)
                try:
                    chunk = src.recv(_CHUNK)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not chunk:
                    break
                if not self._await_open():
                    break
                self._bump("chunks")
                r = rng.random()
                if r < self.truncate_rate:
                    # forward half, then hard-close both ends: the
                    # close-mid-frame fault a dying host produces
                    self._bump("truncated")
                    try:
                        dst.sendall(chunk[: max(1, len(chunk) // 2)])
                    except OSError:
                        pass
                    break
                if r < self.truncate_rate + self.drop_rate:
                    self._bump("dropped")
                    continue             # the chunk never happened
                if r < self.truncate_rate + self.drop_rate + self.delay_rate:
                    self._bump("delayed")
                    time.sleep(self.delay_s)
                try:
                    dst.sendall(chunk)
                    if rng.random() < self.dup_rate:
                        self._bump("duplicated")
                        dst.sendall(chunk)
                except OSError:
                    break
        finally:
            dead.set()
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
