"""horovod_tpu_torch's rank-subset init and top-level surface against
horovod_tpu's.

- ``comm_ranks`` on the reference's communicator stubs
  (``tests/test_basics.py::test_comm_ranks_shim``), the port's answer
  equal to the reference's.
- ``resolve_process_set(ranks)`` under the same launcher environments in
  both packages: a subset, a reordered subset, two hosts, a coordinator
  port of its own, a duplicate, a rank outside the subset.
- Two np 3 jobs under each package's launcher (``tests/torch_twin.py``):
  launcher rank 1 never calls ``init()`` and exits; ranks 0 and 2 run
  ``init(comm=[0, 2])`` and then, after a shutdown, ``init(comm=[0, 2])``
  again with ``HVD_TPU_LOCAL_SIZE`` faking nodes of 2 (one job: rank 0
  coordinates both, so no process binds a port the other may still
  hold); ``init(comm=<communicator>)`` for a reordered subcommunicator,
  whose coordinator is launcher rank 2 (the other job).  These are
  ``tests/test_engine.py``'s two np 3 cases.  Each init is followed by an
  allreduce, an allgather and a broadcast.  ``rank()``, ``size()``,
  ``local_rank()``, ``local_size()`` and every result's bytes equal the
  reference's; ``mpi_threads_supported`` raises before ``init()`` and is
  True after it.
- Every name that ``horovod_tpu/__init__.py`` imports resolves on
  ``horovod_tpu_torch``; ``mpi_threads_supported`` on
  ``horovod_tpu_torch.torch`` too.

Tolerance: none, every value compared is exact.
"""

import ast
import dataclasses
import json
import os

import pytest

from tests import torch_twin as twin
from tests.torch_watch import watched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def engines_built():
    from horovod_tpu.engine import build as ref_build
    from horovod_tpu_torch.engine import build as port_build

    ref_build()
    port_build.build()


class _Comm:
    """The reference's stub communicator: ``allgather`` returns the
    members' launcher ranks in communicator order."""

    def __init__(self, members, size=None):
        self._members, self._size = members, size or len(members)

    def Get_size(self):
        return self._size

    def allgather(self, value):
        assert value in self._members
        return list(self._members)


def test_comm_ranks_shim():
    from horovod_tpu.common.basics import comm_ranks as ref
    from horovod_tpu_torch.common.basics import comm_ranks

    for members, me in (([0, 2], 2), ([3, 1, 5], 1), ([0], 0)):
        assert comm_ranks(_Comm(members), me) == ref(_Comm(members), me) \
            == members
    for fn in (comm_ranks, ref):
        with pytest.raises(ValueError, match="Get_size"):
            fn(_Comm([0, 2], size=3), 0)


_DATA3 = "127.0.0.1:7001,127.0.0.1:7002,127.0.0.1:7003"
_TWO_HOSTS = "10.0.0.1:7001,10.0.0.1:7002,10.0.0.2:7001,10.0.0.2:7002"


def _launcher_env(rank, size, data, coord="127.0.0.1:7000", **extra):
    env = {"HVD_TPU_RANK": rank, "HVD_TPU_SIZE": size,
           "HVD_TPU_COORD": coord, "HVD_TPU_DATA": data}
    env.update(extra)
    return {k: str(v) for k, v in env.items()}


# (launcher environment, ranks): one process's view of a subset.
_SUBSETS = {
    "subset_rank0": (_launcher_env(0, 3, _DATA3), [0, 2]),
    "subset_rank2": (_launcher_env(2, 3, _DATA3), [0, 2]),
    "reordered": (_launcher_env(0, 3, _DATA3), [2, 0]),
    "whole_job": (_launcher_env(1, 3, _DATA3), [0, 1, 2]),
    "two_hosts_first": (_launcher_env(3, 4, _TWO_HOSTS, "10.0.0.1:7000"),
                        [1, 3, 2]),
    "two_hosts_second": (_launcher_env(2, 4, _TWO_HOSTS, "10.0.0.1:7000"),
                         [3, 0, 2]),
    "coord_port": (_launcher_env(2, 3, _DATA3, HVD_TPU_COORD_PORT=7555),
                   [2, 1]),
    "fake_local_size": (_launcher_env(2, 3, _DATA3, HVD_TPU_LOCAL_SIZE=2,
                                      HVD_TPU_LOCAL_RANK=0), [0, 2]),
    "no_launcher": ({}, [0]),
}
_REFUSED = {
    "duplicate": (_launcher_env(0, 3, _DATA3), [0, 0, 2]),
    "outside": (_launcher_env(1, 3, _DATA3), [0, 2]),
}

_IDENTITY = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_LOCAL_RANK",
             "HVD_TPU_LOCAL_SIZE", "HVD_TPU_COORD", "HVD_TPU_DATA",
             "HVD_TPU_COORD_PORT", "CLOUD_TPU_TASK_ID",
             "TPU_PROCESS_ADDRESSES", "TPU_WORKER_ID",
             "TPU_WORKER_HOSTNAMES")


def _resolve(monkeypatch, env, ranks):
    """Both packages' ``resolve_process_set(ranks)`` under ``env``: the
    port's and the reference's answer (or exception) as plain data."""
    from horovod_tpu.common import basics as ref
    from horovod_tpu_torch.common import basics

    for var in _IDENTITY:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = []
    for mod in (basics, ref):
        try:
            ps = mod.resolve_process_set(ranks)
            fields = dataclasses.asdict(ps)
            if fields["data_endpoints"] is not None:
                fields["data_endpoints"] = list(fields["data_endpoints"])
            out.append(fields)
        except ValueError as exc:
            out.append(("ValueError", str(exc)))
    return out


@pytest.mark.parametrize("case", sorted(_SUBSETS))
def test_resolve_process_set_subset_matches_reference(case, monkeypatch):
    env, ranks = _SUBSETS[case]
    port, ref = _resolve(monkeypatch, env, ranks)
    assert port == ref
    assert port["size"] == len(ranks)
    if env:
        assert port["rank"] == ranks.index(int(env["HVD_TPU_RANK"]))


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_resolve_process_set_refusals_match_reference(case, monkeypatch):
    port, ref = _resolve(monkeypatch, *_REFUSED[case])
    assert port == ref and port[0] == "ValueError"


# An np 3 job: launcher rank 1 stays out; ranks 0 and 2 initialize once
# per form of FORMS: on the rank list, on the rank list with nodes of 2
# faked, or on a reordered communicator.  Each member prints one SUBSET
# line a form.
_SUBSET_BODY = """
import json
KW = {"device": "cpu"} if top.__name__ == "horovod_tpu_torch" else {}
me = int(os.environ["HVD_TPU_RANK"])
if me == 1:
    raise SystemExit(0)
try:
    top.mpi_threads_supported()
    before = "no error"
except top.HorovodNotInitializedError:
    before = "HorovodNotInitializedError"


class SubComm:
    # comm rank 0 is launcher rank 2, as MPI.Group.Incl([2, 0]) builds.
    def Get_size(self):
        return 2

    def Get_rank(self):
        return 0 if me == 2 else 1

    def allgather(self, value):
        assert value == me
        return [2, 0]


def report(form):
    r = top.rank()
    out = {"form": form, "before": before,
           "threads": top.mpi_threads_supported(),
           "rank": r, "size": top.size(), "local_rank": top.local_rank(),
           "local_size": top.local_size()}
    s = top.allreduce(arange(37) * (me + 1) + 0.25, average=False,
                      name=form + ".sum")
    a = top.allreduce(arange(5) + me, average=True, name=form + ".avg")
    g = top.allgather(arange(r + 2) + 10 * me, name=form + ".gather")
    b = top.broadcast(arange(6) * (me + 3), 1, name=form + ".bcast")
    out["bytes"] = [to_bytes(t).hex() for t in (s, a, g, b)]
    print("SUBSET " + json.dumps(out, sort_keys=True), flush=True)
    top.shutdown()


for form in FORMS:
    if form == "fake_nodes":
        os.environ["HVD_TPU_LOCAL_SIZE"] = "2"
        os.environ["HVD_TPU_LOCAL_RANK"] = str(me % 2)
    top.init(comm=SubComm() if form == "communicator" else [0, 2], **KW)
    report(form)
"""


def _subset_lines(port, forms):
    program = f"import os\nFORMS = {forms!r}\n" + _SUBSET_BODY
    with watched(70, f"{'port' if port else 'reference'} job {forms}"):
        results = twin.run(port, program, 3, timeout=60.0)
    assert not twin.failures(results), twin.failures(results)
    lines = twin.lines(results, "SUBSET")
    assert lines[1] == []
    return {r: [json.loads(ln) for ln in lines[r]] for r in (0, 2)}


def _jobs(port):
    """Each member's SUBSET lines of both jobs, in the forms' order."""
    first = _subset_lines(port, ["list", "fake_nodes"])
    second = _subset_lines(port, ["communicator"])
    return {r: first[r] + second[r] for r in (0, 2)}


def test_init_comm_subset_jobs_match_reference():
    port, ref = _jobs(True), _jobs(False)
    assert port == ref
    forms = {r: [d["form"] for d in port[r]] for r in port}
    assert forms == {r: ["list", "fake_nodes", "communicator"]
                     for r in (0, 2)}
    for r in (0, 2):
        list_form, nodes, comm_form = port[r]
        assert list_form["rank"] == (0 if r == 0 else 1)
        assert comm_form["rank"] == (0 if r == 2 else 1)
        for d in port[r]:
            assert d["size"] == 2 and d["local_size"] == 2
            assert d["before"] == "HorovodNotInitializedError"
            assert d["threads"] is True
        assert nodes["local_rank"] == nodes["rank"]
    # The two members got the same collective results.
    for i in range(3):
        assert port[0][i]["bytes"] == port[2][i]["bytes"]


def _reference_exports():
    """The names ``horovod_tpu/__init__.py`` imports or assigns."""
    with open(os.path.join(REPO, "horovod_tpu", "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets
                      if isinstance(t, ast.Name)}
    return names


def test_top_level_exports_match_reference():
    import horovod_tpu_torch
    import horovod_tpu_torch.torch as hvd_torch

    names = _reference_exports()
    assert {"allreduce", "send", "stage_group", "StageGroup",
            "mpi_threads_supported", "__version__"} <= names
    missing = sorted(n for n in names if not hasattr(horovod_tpu_torch, n))
    assert missing == []
    assert set(horovod_tpu_torch.__all__) <= set(dir(horovod_tpu_torch))
    assert hvd_torch.mpi_threads_supported \
        is horovod_tpu_torch.mpi_threads_supported


def test_mpi_threads_supported_before_and_after_init(monkeypatch):
    import horovod_tpu_torch as hvd

    for var in _IDENTITY:
        monkeypatch.delenv(var, raising=False)
    hvd.shutdown()
    with pytest.raises(hvd.HorovodNotInitializedError):
        hvd.mpi_threads_supported()
    hvd.init(device="cpu")
    try:
        assert hvd.mpi_threads_supported() is True
    finally:
        hvd.shutdown()
