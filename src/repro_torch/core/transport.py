"""Transport layer of the replication fabric: framed byte pipes.

The wire protocol (``core/wire.py`` + the control tags in
``core/replication.py``) is transport-agnostic by construction:
length-prefixed frames, exactly one reply per request, and the only bulk
payload is a delta buffer. This module gives that invariant a name — a
minimal :class:`Transport` — and two interchangeable implementations:

* :class:`PipeTransport` — a ``multiprocessing`` duplex pipe, the PR 4
  plumbing extracted. Frames ride the pipe's own length-prefixed message
  protocol (``send_bytes``/``recv_bytes``); parent and child must share a
  machine.
* :class:`TCPTransport` — a TCP stream with an explicit ``u64``
  length prefix per frame, so a replica can run on ANOTHER HOST unchanged:
  the parent listens (:class:`TCPListener`, ``host:port``), the child
  connects (:func:`connect_tcp`). Tests and CI run the same code over
  127.0.0.1 loopback (or a :func:`TCPTransport.pair` socketpair), which is
  exactly the multi-host path minus the NIC.

Contract shared by all implementations (what the fabric layer relies on):

* ``send_bytes(buf)`` ships one complete frame; ``recv_bytes()`` returns
  one complete frame or raises ``EOFError`` when the peer is gone.
* ``poll(timeout)`` waits for a readable frame without consuming it.
* ``try_send(buf, timeout)`` is the shutdown-path best-effort send: it
  must NEVER block indefinitely (a wedged or dead peer cannot hang
  ``close()``/``__del__``) and returns False instead of raising.
* Framing preserves message boundaries and order; there is no interleaving
  because each direction has a single writer (the request/reply discipline
  serializes on the fabric's lock).
"""
from __future__ import annotations

import multiprocessing.connection
import select
import socket
import struct
import time
from typing import Optional, Tuple


class TransportError(ConnectionError):
    """The peer is gone or the stream is corrupt mid-frame."""


class Transport:
    """Minimal framed-bytes interface the replication fabric speaks.

    Both implementations are FULL-DUPLEX: a send and a recv may be in
    flight at once (pipe and TCP both buffer each direction
    independently), which is what lets the pipelined shipper keep a
    window of unacked delta frames on the wire and harvest acks while the
    next frame encodes — the request/reply discipline still holds per
    frame (every D gets exactly one A, in order), only the LOCKSTEP is
    relaxed.
    """

    def send_bytes(self, buf) -> None:
        raise NotImplementedError

    def send_chunks(self, chunks) -> None:
        """Ship ONE frame given as multiple bytes-like chunks (header +
        encoded buffers), avoiding the caller-side join where the
        transport can scatter-gather. Base implementation joins."""
        self.send_bytes(b"".join(chunks))

    def recv_bytes(self) -> bytes:
        raise NotImplementedError

    def poll(self, timeout: Optional[float] = 0.0) -> bool:
        raise NotImplementedError

    def fileno(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def try_send(self, buf, timeout: float = 1.0) -> bool:
        """Best-effort send that never blocks past ``timeout`` and never
        raises — the graceful-shutdown path (a tiny control frame to a peer
        that may be dead, wedged, or mid-read). Returns True only when the
        frame was handed to the OS."""
        try:
            _, writable, _ = select.select([], [self.fileno()], [], timeout)
            if not writable:
                return False
            self.send_bytes(buf)
            return True
        except (OSError, ValueError, EOFError, BrokenPipeError):
            return False


class PipeTransport(Transport):
    """A ``multiprocessing`` duplex pipe endpoint as a Transport.

    The Connection already speaks length-prefixed messages, so frames map
    1:1 onto ``send_bytes``/``recv_bytes``; this class only normalizes the
    error surface (peer loss -> ``EOFError``) and adds ``try_send``.
    """

    def __init__(self, conn: multiprocessing.connection.Connection):
        self.conn = conn

    def send_bytes(self, buf) -> None:
        self.conn.send_bytes(buf)

    def recv_bytes(self) -> bytes:
        return self.conn.recv_bytes()          # raises EOFError on peer loss

    def poll(self, timeout: Optional[float] = 0.0) -> bool:
        return self.conn.poll(timeout)

    def fileno(self) -> int:
        return self.conn.fileno()

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


_LEN = struct.Struct("<Q")
# Frames above this are a corrupt length prefix, not a real payload: the
# largest legitimate delta is bounded by log memory, far below 1 TiB.
_MAX_FRAME = 1 << 40


class TCPTransport(Transport):
    """A connected TCP stream as a Transport: ``u64 length | payload``.

    ``TCP_NODELAY`` is set — the request/reply protocol ships many small
    control frames, and Nagle would serialize them against the peer's ACK
    clock. Construction sites: :func:`TCPTransport.pair` (in-process
    loopback for tests), :class:`TCPListener` + :func:`connect_tcp`
    (parent/child across processes — or across hosts: nothing below cares
    where the other end of the socket lives).
    """

    def __init__(self, sock: socket.socket,
                 recv_timeout: Optional[float] = None):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass          # AF_UNIX socketpair (the test rig) has no Nagle
        sock.setblocking(True)
        self.sock = sock
        # per-read deadline: a hung peer (live socket, nothing arriving)
        # surfaces as a TransportError instead of blocking recv forever.
        # None = wait indefinitely (the pre-knob behavior).
        self.recv_timeout = recv_timeout

    @classmethod
    def pair(cls, recv_timeout: Optional[float] = None
             ) -> Tuple["TCPTransport", "TCPTransport"]:
        """Connected loopback endpoints (socketpair) — the unit-test rig.
        ``recv_timeout`` applies to both ends: a wedged peer surfaces as a
        ``TransportError`` on recv instead of a hung thread."""
        a, b = socket.socketpair()
        return cls(a, recv_timeout=recv_timeout), cls(b, recv_timeout=recv_timeout)

    def send_bytes(self, buf) -> None:
        n = len(buf)
        try:
            if n < 4096:
                # control frames: one syscall for prefix+payload
                self.sock.sendall(_LEN.pack(n) + bytes(buf))
            else:
                # bulk deltas: no copy, sendall handles partial writes
                self.sock.sendall(_LEN.pack(n))
                self.sock.sendall(buf)
        except OSError as e:
            raise TransportError(f"tcp send failed: {e}") from e

    def send_chunks(self, chunks) -> None:
        """Vectored frame send: length prefix + chunks in one ``sendmsg``
        (scatter-gather — no join copy of a multi-buffer delta frame).
        Falls back to the join path when the kernel's iovec limit or a
        partial write gets in the way."""
        bufs = [memoryview(c) for c in chunks]
        total = sum(b.nbytes for b in bufs)
        iov = [memoryview(_LEN.pack(total))] + [b for b in bufs if b.nbytes]
        try:
            sent = self.sock.sendmsg(iov)
        except OSError as e:
            raise TransportError(f"tcp send failed: {e}") from e
        want = _LEN.size + total
        if sent == want:
            return
        # partial vectored write (large frame vs socket buffer): finish
        # with the joined remainder — correctness over zero-copy
        rest = b"".join(iov)[sent:]
        try:
            self.sock.sendall(rest)
        except OSError as e:
            raise TransportError(f"tcp send failed: {e}") from e

    def _recv_exact(self, n: int) -> bytes:
        out = bytearray(n)
        view = memoryview(out)
        got = 0
        while got < n:
            if self.recv_timeout is not None:
                readable, _, _ = select.select(
                    [self.sock], [], [], self.recv_timeout)
                if not readable:
                    raise TransportError(
                        f"tcp recv timed out after {self.recv_timeout}s "
                        f"({got}/{n} bytes of the frame received)")
            try:
                k = self.sock.recv_into(view[got:], n - got)
            except OSError as e:
                raise EOFError(f"tcp recv failed: {e}") from e
            if k == 0:
                raise EOFError("tcp peer closed mid-frame")
            got += k
        return bytes(out)

    def recv_bytes(self) -> bytes:
        (n,) = _LEN.unpack(self._recv_exact(_LEN.size))
        if n > _MAX_FRAME:
            raise TransportError(f"tcp frame length {n} is not credible — "
                                 "stream is corrupt or misaligned")
        return self._recv_exact(int(n))

    def poll(self, timeout: Optional[float] = 0.0) -> bool:
        readable, _, _ = select.select([self.sock], [], [], timeout)
        return bool(readable)

    def fileno(self) -> int:
        return self.sock.fileno()

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class TCPListener:
    """Parent-side accept socket: bind an ephemeral (or given) port, spawn
    the replica with the address, ``accept`` its connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(1)

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self.sock.getsockname()[:2]
        return host, int(port)

    def accept(self, timeout: float = 60.0) -> TCPTransport:
        readable, _, _ = select.select([self.sock], [], [], timeout)
        if not readable:
            raise TimeoutError(
                f"no replica connected within {timeout}s")
        conn, _addr = self.sock.accept()
        return TCPTransport(conn)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def connect_tcp(host: str, port: int, timeout: float = 60.0,
                retry_every: float = 0.05, max_retry_every: float = 1.0,
                max_retries: Optional[int] = None) -> TCPTransport:
    """Child-side connect with bounded exponential backoff — the listener
    may not be accepting yet when a freshly spawned interpreter gets here
    first (replica spawn races the listener under load). The retry interval
    doubles from ``retry_every`` up to ``max_retry_every`` so a slow
    listener isn't hammered at 20 Hz for the whole window; the attempt
    budget is bounded by ``timeout`` (deadline) and optionally
    ``max_retries``. The last OSError propagates when the budget runs out.
    """
    deadline = time.monotonic() + timeout
    delay = retry_every
    attempts = 0
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=timeout)
            return TCPTransport(sock)
        except OSError:
            attempts += 1
            if time.monotonic() >= deadline or \
                    (max_retries is not None and attempts > max_retries):
                raise
            time.sleep(min(delay, max(deadline - time.monotonic(), 0.0)))
            delay = min(delay * 2, max_retry_every)


def child_endpoint(spec) -> Transport:
    """Materialize the replica-process end of a transport from the picklable
    spec the parent passed to ``Process(args=...)``:
    ``("pipe", conn)`` or ``("tcp", host, port)``."""
    kind = spec[0]
    if kind == "pipe":
        return PipeTransport(spec[1])
    if kind == "tcp":
        return connect_tcp(spec[1], spec[2])
    raise ValueError(f"unknown transport spec {spec!r}")
