"""The kernel tools' source edits and readings, on the CPU.

``tools/torch_kernel_control.py`` builds mutants and
``tools/torch_split_variants.py`` variants of the CUDA sources by
replacing one piece of text in a copy of a source; the piece must occur
exactly once, or the tool stops before it builds anything on the card.
These tests hold every such piece against the checked-in sources, so a
change to a kernel that moves one shows here and not in a chip run.
``tools/torch_phase_turns.py`` reads each phase's line by its keys.
"""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "horovod_tpu_torch", "ops", "csrc")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


control = _tool("torch_kernel_control")
atomics = _tool("torch_bwd_atomics")
variants = _tool("torch_split_variants")
turns = _tool("torch_phase_turns")


def _mutant_edits():
    """(mutant, file, text replaced) of every mutant the control builds."""
    edits = [(n, f, old) for n, (_, f, old, _, _) in control.MUTANTS.items()]
    edits += [(n, f, old) for n, (_, f, old, _, _)
              in control.RING_MUTANTS.items()]
    edits += [(n, f, old) for n, (f, old, _) in control.WIDE_MUTANTS.items()]
    edits += [(n, f, old) for n, (f, old, _, _, _)
              in control.F32_MUTANTS.items()]
    edits += [(n, f, old) for n, (f, old, _)
              in control.RING_F32_MUTANTS.items()]
    edits += [(n, f, old) for n, (f, old, _, _, _)
              in control.D256_MUTANTS.items()]
    return edits


def _variant_edits():
    return [(f"{family}/{name}", f, old)
            for family, spec in variants.FAMILIES.items()
            for name, (edits, _) in spec["variants"].items()
            for f, old, _ in edits]


def _count(file, text):
    with open(os.path.join(CSRC, file)) as f:
        return f.read().count(text)


@pytest.mark.parametrize("name,file,old", _mutant_edits(),
                         ids=[e[0] for e in _mutant_edits()])
def test_each_mutant_line_occurs_once(name, file, old):
    assert _count(file, old) == 1, (name, file)


@pytest.mark.parametrize("name,file,old", _variant_edits(),
                         ids=[e[0] for e in _variant_edits()])
def test_each_variant_line_occurs_once(name, file, old):
    assert _count(file, old) == 1, (name, file)


def test_ring_f32_mutants_edit_the_f32_bodies_of_the_ring_build():
    """The f32 ring mutants change the header K4 and K5 run in f32, and
    the control builds them into ring_flash alone."""
    with open(os.path.join(CSRC, "ring_flash.cu")) as f:
        assert '#include "flash_wide_f32_sm90.cuh"' in f.read()
    assert {f for f, _, _ in control.RING_F32_MUTANTS.values()} == {
        control.F32_BODY}


def test_phase_turns_read_the_ring_kernels_line():
    rec = {"phase": "ring_kernels",
           "timing": {"ring_flash_fwd": {"ms": 0.031},
                      "ring_flash_bwd": {"ms": 0.076}},
           "f32": {"ring_flash_fwd": {"ms": 0.2},
                   "ring_flash_bwd": {"ms": 0.7}}}
    assert turns.metric("ring_kernels", rec) == {
        "k4_bf16": 0.031, "k5_bf16": 0.076, "k4_f32": 0.2, "k5_f32": 0.7}
    assert turns.METRIC["ring_kernels"] == "ms"


def test_smoke_seconds_stamp_each_phase(tmp_path):
    """``tools/torch_smoke_seconds.py`` runs a checkout's chip_smoke.py,
    stamps every line and gives each phase the seconds since the line
    before it, and the build phase's seconds per source."""
    import json
    import subprocess
    import sys

    (tmp_path / "chip_smoke.py").write_text(
        "import json, time\n"
        "print(json.dumps({'phase': 'device'}))\n"
        "time.sleep(0.2)\n"
        "print(json.dumps({'phase': 'build', "
        "'sources': {'flash_fwd': {'seconds': 1.5}}}))\n"
        "print('not a phase')\n")
    out = tmp_path / "stamped"
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "torch_smoke_seconds.py"),
         "--root", str(tmp_path), "--out", str(out)],
        capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, run.stderr
    rec = json.loads(run.stdout.splitlines()[-1])
    assert [p for p, _ in rec["phases"]] == ["device", "build"]
    assert rec["phases"][1][1] >= 0.2
    assert rec["build_sources"] == {"flash_fwd": 1.5}
    lines = out.read_text().splitlines()
    assert len(lines) == 3 and lines[2].endswith("\tnot a phase")


def test_b2_family_takes_each_lever_alone_and_combined():
    """``--family b2`` times B2's checked-in body (every lever on) against
    the parent's body (every lever off), each lever alone (pipelining and
    the dQ buffers on the 256-thread CTA they belong to) and each lever
    taken out of the combination; each variant's edits are those that
    turn its other levers off."""
    levers, needs = set(variants.B2_LEVERS), variants.B2_NEEDS
    on = {n: set(v) for n, v in variants.B2_VARIANTS.items()}
    for lever in levers:
        alone = {lever} | ({needs[lever]} if lever in needs else set())
        assert alone in on.values(), lever
        if lever not in needs.values():  # levers no other lever needs
            assert levers - {lever} in on.values(), lever
    assert set() in on.values()
    for name, kept in on.items():
        assert all(needs.get(x, x) in kept for x in kept), name
        edits = variants.FAMILIES["b2"]["variants"][name][0]
        assert edits == variants.b2_edits(kept), name
        assert (variants._B2_HEAD_FASTEST in edits) == (
            "grid_order" not in kept), name
        assert (variants._B2_PARENT_BODY[0] in edits) == (
            "cta256" not in kept), name


def test_b2_mutants_edit_b2s_own_body():
    """B2's mutants change its own body (``flash_b2_sm90.cuh``), built into
    ``flash_bwd`` alone; ``--b2`` reads them and no other."""
    b2 = {n: m for n, m in control.MUTANTS.items() if m[0] == "flash_bwd"}
    assert set(b2) == {"bwd_dq_drops_last_k16_slice", "bwd_qt0_one_tile_late",
                       "bwd_dv_skips_6pct_of_rows",
                       "bwd_stage_refilled_early"}
    assert {m[1] for m in b2.values()} == {control.B2_BODY}
    with open(os.path.join(CSRC, "flash_bwd.cu")) as f:
        assert f'#include "{control.B2_BODY}"' in f.read()


@pytest.mark.parametrize("dtype", sorted(atomics.ADDS, key=str), ids=str)
def test_each_atomics_edit_occurs_once(dtype):
    """``tools/torch_bwd_atomics.py`` drops B2's dQ adds by deleting its
    body's reduce line: in 16 bits B2's own body's, in float32 the 3xTF32
    body's."""
    file, old, _ = atomics.ADDS[dtype]
    assert _count(file, old) == 1, (dtype, file)
