"""The control comes out not correct: the reference in the program's
place with its products in float8 (``control.py``), and half the batch
left out, judged by the cell's limits. On the CPU at a tiny size; on the
card, marked ``cuda``, at a cell's own size."""
import os

import pytest
import torch

from portbench import check, control
from portbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("family,co_tenant", [("dense", "vlm"),
                                              ("hybrid", None)])
def test_control_and_half_batch_fail_tiny(tmp_path, family, co_tenant):
    root = tiny.make_root(tmp_path, family, co_tenant)
    got = control.readings(root, "tiny.t", [1, 2], ["control", "half_batch"],
                           "cpu", out=lambda line: None)
    limits = check.load_limits(root, "tiny.t")
    for (job, seed, kind), nums in got.items():
        ok, _ = check.judge({job: nums}, limits)
        assert not ok, (job, seed, kind, nums)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["minicpm-2b.solo"])
def test_control_fails_the_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    got = control.readings(ROOT, cell, [5], ["control"], "cuda",
                           out=lambda line: None)
    limits = check.load_limits(ROOT, cell)
    for (job, _, _), nums in got.items():
        assert not check.judge({job: nums}, limits)[0], nums
