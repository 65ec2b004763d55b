"""The port's host-side chaos scenarios on the CPU, at the reference's
seeds (``tests/test_chaos.py``): the WAL cut at every (strided) offset,
and a drain past a wedged driver.  A file of few tests (ROADMAP R2).
"""

import pytest
import torch

from nomad_tpu_torch.chaos.scenarios import SCENARIOS
from torch_parity import assert_chaos_report

torch.set_num_threads(1)


def test_wal_truncation_sweep(tmp_path):
    report = SCENARIOS["wal_truncation_sweep"](7, str(tmp_path),
                                               device="cpu")
    assert_chaos_report(report)
    assert report["cuts"] > 10


def test_wedged_driver_during_drain(tmp_path):
    report = SCENARIOS["wedged_driver_during_drain"](5, str(tmp_path),
                                                     device="cpu")
    assert_chaos_report(report)
    kinds = {k for _, k, _ in report["faults"]}
    assert "skip" in kinds and "wedge" in kinds, report


@pytest.mark.slow
def test_wal_truncation_every_offset(tmp_path):
    """stride=1: restore from a cut at EVERY byte offset."""
    report = SCENARIOS["wal_truncation_sweep"](0, str(tmp_path), stride=1,
                                               device="cpu")
    assert_chaos_report(report)
