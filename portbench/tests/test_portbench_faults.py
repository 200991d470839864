"""A run with the timed path broken underneath: the harness's look for a
card skipped (the CPU, the kernels' plain versions, a tiny size), the
rest of a run driven, and ``correct`` false for each fault a cell can
have; true with none."""

import time

import pytest
import torch

from portbench import faults, run


def _run(tiny_bench, cell, fault):
    bench, root, pkg = tiny_bench
    return run.execute(bench, run.workload(bench, cell), 11, 0.3, False,
                       torch.device("cpu"), time.perf_counter(),
                       fault=fault, root=root, pkg=pkg)


@pytest.mark.parametrize("cell", ["tiny.dec", "tiny.tr"])
def test_sound_run_is_correct(tiny_bench, cell):
    out = _run(tiny_bench, cell, None)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny.dec", f) for f in faults.FAULTS["decode"]] + [
    ("tiny.tr", f) for f in faults.FAULTS["train"]])
def test_fault_makes_the_run_incorrect(tiny_bench, cell, fault):
    out = _run(tiny_bench, cell, fault)
    assert not out["correct"], (fault, out["checks"])
    assert "checks" in out and "_checks" in out
