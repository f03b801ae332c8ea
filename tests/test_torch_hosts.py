"""horovod_tpu_torch's multi-host launcher against horovod_tpu's
(``tests/test_hosts.py``'s contracts, without the TPU pinning cases: the
port pins ``cuda:local_rank()`` in ``init()``).

- ``hosts.parse_hosts``, ``plan`` and ``ssh_command`` give the reference's
  answers on the same specs (a plan's environment less the reference's
  XLA-plane coordinator), errors included;
- ``run_hosts`` over ``127.0.0.2``, a loopback address that is not this
  host by name, runs a rank through a fake ``ssh`` on ``PATH`` (it runs
  the remote command from ``/`` in a scrubbed environment, so only the
  inlined ``cd`` and exports get the rank there); the rank's allreduce
  and output equal the reference's run of the same program;
- ``run_hosts`` with every slot on ``127.0.0.1`` (the fixed-port plan
  without ssh), at np 3, under both packages; and the CLI's ``-H`` with
  ``--port-base``, which refuses elastic membership.
"""

import os
import socket
import stat
import subprocess
import sys

import pytest

from tests import torch_twin as twin


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


def _hosts():
    from horovod_tpu.runner import hosts as ref
    from horovod_tpu_torch.runner import hosts as port

    return port, ref


def _outcome(fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("spec", [
    "a:2,b:4", "single", "a:0", "", "a:2,a:2", "[::1]:2,b", "::1",
    " a:1 , b:2 ,", "a:-1"])
def test_parse_hosts_matches_the_reference(spec):
    port, ref = _hosts()
    assert _outcome(port.parse_hosts, spec) == _outcome(ref.parse_hosts, spec)
    assert port.DEFAULT_PORT_BASE == ref.DEFAULT_PORT_BASE


def _placements(mod, *args, **kwargs):
    out = _outcome(mod.plan, *args, **kwargs)
    if isinstance(out, tuple):
        return out
    return [(p.rank, p.host, p.local_rank, p.local_size,
             {k: v for k, v in p.env.items() if k != "HVD_TPU_XLA_COORD"})
            for p in out]


@pytest.mark.parametrize("np_,spec,port_base", [
    (6, "hostA:2,hostB:4", 50000), (3, "a:2,b:4", None), (5, "a:2,b:2", None),
    (4, "a:2,a:2", 52000), (4, "x:2,y:2", 60000), (1, "localhost", 40000)])
def test_plan_matches_the_reference(np_, spec, port_base):
    port, ref = _hosts()
    kwargs = {} if port_base is None else {"port_base": port_base}
    got = _placements(port, np_, spec, **kwargs)
    assert got == _placements(ref, np_, spec, **kwargs)
    if isinstance(got, tuple):
        assert "exceeds" in got[1]


def test_plan_contiguous_blocks():
    port, _ = _hosts()
    ps = port.plan(6, "hostA:2,hostB:4", port_base=50000)
    assert [p.host for p in ps] == ["hostA"] * 2 + ["hostB"] * 4
    assert [p.local_rank for p in ps] == [0, 1, 0, 1, 2, 3]
    assert all(p.local_size == (2 if p.host == "hostA" else 4) for p in ps)
    assert all(p.env["HVD_TPU_COORD"] == "hostA:50000" for p in ps)
    data = ps[0].env["HVD_TPU_DATA"].split(",")
    assert data[0] == "hostA:50001" and data[2] == "hostB:50001"
    assert data[5] == "hostB:50004"
    assert [int(p.env["HVD_TPU_RANK"]) for p in ps] == list(range(6))
    ps = port.plan(4, "a:2,a:2", port_base=52000)
    assert [p.local_rank for p in ps] == [0, 1, 2, 3]
    assert len(set(ps[0].env["HVD_TPU_DATA"].split(","))) == 4


def test_ssh_command_matches_the_reference():
    port, ref = _hosts()
    args = (["python", "train.py", "--lr", "0.1"],)
    kwargs = dict(extra_env={"PYTHONPATH": "/x y"}, cwd="/work dir",
                  ssh_args=("-p", "2222"))
    got = port.ssh_command(port.plan(2, "remotehost:2", port_base=51000)[1],
                           *args, **kwargs)
    want = ref.ssh_command(ref.plan(2, "remotehost:2", port_base=51000)[1],
                           *args, **kwargs)
    assert got[:4] == want[:4] == ["ssh", "-p", "2222", "remotehost"]
    drop = "HVD_TPU_XLA_COORD=remotehost:51500 "
    assert got[4] == want[4].replace(drop, "")
    assert got[4].startswith("cd '/work dir' 2>/dev/null; ")
    assert "HVD_TPU_RANK=1" in got[4] and "PYTHONPATH='/x y'" in got[4]
    assert "python train.py --lr 0.1" in got[4]
    assert port.is_local_host("127.0.0.1") and port.is_local_host(
        socket.gethostname())
    assert not port.is_local_host("127.0.0.2")


def _free_port_base(span=501):
    """A port base whose data (+1) and the reference's XLA (+500) offsets
    are free too."""
    from horovod_tpu_torch.common.basics import pick_free_port

    for _ in range(20):
        base = pick_free_port()
        if base + span > 65535:
            continue
        ok = True
        for off in (1, 2, 3, 500):
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", base + off))
                except OSError:
                    ok = False
                    break
        if ok:
            return base
    raise RuntimeError("no free port range found")


# One write a line: the CLI's ranks share the launcher's stdout.
_RANK = (
    "import os, sys\n"
    "INIT()\n"
    "out = hvd.allreduce(ones(8) * (hvd.rank() + 1), average=False,\n"
    "                    name='h')\n"
    "fields = ('RANK_OK', hvd.rank(), hvd.local_rank(), hvd.local_size(),\n"
    "          as_list(out)[0], os.environ.get('MARKER'), os.getcwd())\n"
    "sys.stdout.write(' '.join(map(str, fields)) + '\\n')\n"
    "sys.stdout.flush()\n"
)


def _run_hosts(port, np_, spec, **kwargs):
    runner = twin.launcher(port)
    return runner.run_hosts(
        [sys.executable, "-c", twin.program(port, _RANK)], np_, spec,
        port_base=_free_port_base(), timeout=90.0, capture=True, **kwargs)


def test_run_hosts_ssh_path_with_fake_ssh(tmp_path, monkeypatch):
    """The remote branch end to end through a fake ``ssh``: the rank gets
    the inlined environment (``MARKER``) and working directory."""
    shim = tmp_path / "ssh"
    shim.write_text(
        "#!/bin/sh\nshift\ncd /\nexec env -i PATH=\"$PATH\" sh -c \"$1\"\n")
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}" + os.environ["PATH"])
    env = twin.env(MARKER="made-it-through-ssh")
    results = {port: _run_hosts(port, 1, "127.0.0.2:1", env=env)
               for port in (True, False)}
    for port, res in results.items():
        assert res[0].returncode == 0, (port, res[0].stderr[-800:])
    got, want = (twin.lines(results[p], "RANK_OK") for p in (True, False))
    assert got == want == {0: [
        f"0 0 1 1.0 made-it-through-ssh {os.path.realpath(os.getcwd())}"]}


def test_run_hosts_local_live():
    """Every slot on 127.0.0.1: the fixed-port plan's endpoints agree, and
    each rank sees its local rank and size, as the reference's."""
    results = {port: _run_hosts(port, 3, "127.0.0.1:3", env=twin.env())
               for port in (True, False)}
    for port, res in results.items():
        assert not twin.failures(res), twin.failures(res)
    got, want = (twin.lines(results[p], "RANK_OK") for p in (True, False))
    assert got == want
    assert [got[r][0].split()[:4] for r in range(3)] == [
        [str(r), str(r), "3", "6.0"] for r in range(3)]


def test_cli_hosts_and_port_base(tmp_path):
    """``-H`` with ``--port-base`` through the CLI; ``-H`` with elastic
    membership is a usage error, as in the reference."""
    script = tmp_path / "job.py"
    script.write_text(twin.program(True, _RANK))
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", "2",
           "-H", "127.0.0.1:2", "--port-base", str(_free_port_base())]
    proc = subprocess.run(cmd + ["--", sys.executable, str(script)],
                          env=twin.env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sorted(ln.split()[1] for ln in proc.stdout.splitlines()
                  if ln.startswith("RANK_OK")) == ["0", "1"]
    proc = subprocess.run(cmd + ["--min-np", "1", "--", sys.executable,
                                 str(script)], env=twin.env(),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
    assert "supports single-host launches only" in proc.stderr
