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
