"""The port launcher's endpoints lie outside the host's ephemeral range.

``horovod_tpu_torch.common.basics.pick_free_ports`` (the launcher's
``allocate_endpoints`` and its re-pick for a standby) picks the ports its
ranks bind 1-3 s later.  Inside the host's ephemeral range (Linux's
``ip_local_port_range``) any outgoing connection on the host may take a
picked port as its source port in between, and the rank's engine then
fails its ``Listen`` with ``Address already in use``.  These tests hold
the picks outside that range, distinct and bindable, and a batch through
a burst of outgoing connections made between the pick and the bind.
"""

import socket

import pytest

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.runner.launch import allocate_endpoints


def _outside(port, low, high):
    return basics._LOWEST_PORT <= port <= 65535 and not low <= port <= high


@pytest.mark.parametrize("n", [1, 9, 64])
def test_picked_ports_lie_outside_the_local_range_and_bind(n):
    low, high = basics.local_port_range()
    ports = basics.pick_free_ports(n)
    assert len(ports) == n and len(set(ports)) == n
    assert all(_outside(p, low, high) for p in ports), (ports, low, high)
    held = []
    try:
        for p in ports:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            held.append(s)
            s.bind(("127.0.0.1", p))
    finally:
        for s in held:
            s.close()
    assert _outside(basics.pick_free_port(), low, high)


def test_allocate_endpoints_lie_outside_the_local_range():
    low, high = basics.local_port_range()
    coord, data = allocate_endpoints(4)
    ports = [int(ep.rsplit(":", 1)[1]) for ep in [coord] + data]
    assert len(set(ports)) == 5
    assert all(_outside(p, low, high) for p in ports), (ports, low, high)


def test_a_batch_survives_a_burst_of_connections_before_the_bind():
    """Between the pick and the ranks' binds, 200 outgoing connections on
    the host each take a source port from the ephemeral range: none takes
    a picked port, and every picked port then binds and listens."""
    low, high = basics.local_port_range()
    ports = basics.pick_free_ports(8)
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.bind(("127.0.0.1", 0))
    server.listen(512)
    clients, accepted, held = [], [], []
    try:
        for _ in range(200):
            c = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            clients.append(c)
            c.connect(server.getsockname())
            accepted.append(server.accept()[0])
        sources = {c.getsockname()[1] for c in clients}
        assert not sources & set(ports)
        assert all(low <= p <= high for p in sources), sorted(sources)[:5]
        for p in ports:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            held.append(s)
            s.bind(("127.0.0.1", p))
            s.listen(1)
    finally:
        for s in clients + accepted + held + [server]:
            s.close()


def test_local_port_range_reads_proc_else_the_linux_default(monkeypatch):
    low, high = basics.local_port_range()
    assert 0 < low <= high <= 65535

    def missing(*a, **kw):
        raise OSError("no /proc")

    monkeypatch.setattr("builtins.open", missing)
    assert basics.local_port_range() == basics._DEFAULT_LOCAL_PORTS


def test_a_range_that_leaves_no_room_falls_back_to_the_kernel(monkeypatch):
    """Where the ephemeral range covers every port above the lowest one
    handed out, the kernel picks (port 0): still distinct and bindable."""
    monkeypatch.setattr(basics, "local_port_range", lambda: (1024, 65535))
    ports = basics.pick_free_ports(4)
    assert len(set(ports)) == 4 and all(1024 <= p <= 65535 for p in ports)
