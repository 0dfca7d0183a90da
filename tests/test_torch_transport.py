"""The port's transport (``repro_torch.core.transport``) against the
reference's (``tests/test_transport.py``): the same frames cross between
the two packages' endpoints both ways, over a TCP socket and a pipe, so
the framing is one protocol; and the port keeps the reference's edge
cases (corrupt length prefix, EOF, recv deadline, try_send on a dead peer,
listener accept timeout, bounded connect retries)."""
import multiprocessing
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import transport as ref_tp  # noqa: E402
from repro_torch.core import transport as tp  # noqa: E402

PKGS = {"reference": ref_tp, "port": tp}
FRAMES = [b"", b"x", b"hello" * 100, np.arange(1000).tobytes()]


def _tcp_pair(tx_mod, rx_mod):
    """A connected (sender, receiver) across the two packages: the
    receiver listens, the sender connects."""
    listener = rx_mod.TCPListener()
    host, port = listener.address
    box = {}
    t = threading.Thread(
        target=lambda: box.setdefault("c", tx_mod.connect_tcp(host, port)))
    t.start()
    server = listener.accept(timeout=10)
    t.join(timeout=10)
    assert not t.is_alive()
    listener.close()
    return box["c"], server


@pytest.mark.parametrize("tx,rx", [("reference", "port"),
                                   ("port", "reference"),
                                   ("port", "port")])
def test_tcp_frames_cross_between_packages(tx, rx):
    a, b = _tcp_pair(PKGS[tx], PKGS[rx])
    for f in FRAMES:
        a.send_bytes(f)
    assert [b.recv_bytes() for _ in FRAMES] == FRAMES
    chunks = [b"D" + b"\x00" * 24, b"hot" * 500, b""]
    a.send_chunks(chunks)                   # scatter-gather: one frame
    assert b.recv_bytes() == b"".join(chunks)
    b.send_bytes(b"reply")
    assert a.recv_bytes() == b"reply"
    a.close()
    b.close()


@pytest.mark.parametrize("tx,rx", [("reference", "port"),
                                   ("port", "reference")])
def test_pipe_frames_cross_between_packages(tx, rx):
    c1, c2 = multiprocessing.Pipe()
    a, b = PKGS[tx].PipeTransport(c1), PKGS[rx].PipeTransport(c2)
    for f in FRAMES:
        a.send_bytes(f)
    assert [b.recv_bytes() for _ in FRAMES] == FRAMES
    a.send_chunks([b"ab", b"", b"cd"])
    assert b.recv_bytes() == b"abcd"
    a.close()
    b.close()


def test_tcp_edge_cases_match_the_reference():
    """Corrupt prefix, EOF on peer close, a recv deadline (not sticky),
    try_send on a dead peer: each raises or returns as the reference's."""
    for mod in (tp, ref_tp):
        a, b = mod.TCPTransport.pair()
        assert not b.poll(0.0)
        a.sock.sendall(b"\xff" * 8)
        with pytest.raises(mod.TransportError):
            b.recv_bytes()
        a.close()
        b.close()
        a, b = mod.TCPTransport.pair()
        a.recv_timeout = 0.05
        with pytest.raises(mod.TransportError, match="timed out"):
            a.recv_bytes()
        b.sock.sendall(mod._LEN.pack(64))
        with pytest.raises(mod.TransportError, match="0/64 bytes"):
            a.recv_bytes()
        b.send_bytes(b"late")
        assert a.recv_bytes() == b"late"
        b.close()
        with pytest.raises(EOFError):
            a.recv_bytes()
        assert [a.try_send(b"Q", timeout=0.2) for _ in range(3)][-1] is False
        a.close()
        assert a.try_send(b"Q", timeout=0.2) is False
    assert tp._LEN.format == ref_tp._LEN.format


def test_listener_and_connect_bounds():
    """accept times out without a client; connect_tcp gives up after its
    retries; child_endpoint refuses an unknown spec, as the reference."""
    listener = tp.TCPListener()
    with pytest.raises(TimeoutError):
        listener.accept(timeout=0.05)
    host, port = listener.address
    listener.close()
    with pytest.raises(OSError):
        tp.connect_tcp(host, port, timeout=30.0, retry_every=0.01,
                       max_retry_every=0.02, max_retries=3)
    with pytest.raises(ValueError, match="transport spec"):
        tp.child_endpoint(("carrier-pigeon",))
