"""The port's device-fault-domain chaos scenarios on the CPU, at the
reference's seeds and sizes (``tests/test_chaos.py::TestScenarios``).

The port has no host twin, so an open breaker refuses dispatches (nothing
launched) and the refused evals come back through nack, redelivery and
the failed-eval reaper; ``placed_after_close`` holds at 16 nodes, where
the scenario's measurement bursts leave room for the crowd (at the
reference's 4 nodes they fill the cluster first: 293 jobs of 40-70 MHz
against 4 × 3,900 MHz, so the crowd blocks, as the reference's does).
A file of few tests, apart from the injector and seam cases (ROADMAP R2).
"""

import pytest
import torch

from nomad_tpu_torch.chaos.scenarios import SCENARIOS
from torch_parity import assert_chaos_report

torch.set_num_threads(1)


def test_wedged_dispatch_recovers(tmp_path):
    """One wedged wait at pipeline depth 8: the breaker trips, refuses
    dispatches while open (each a refusal, nothing launched), no future
    hangs, the half-open canary re-closes it, and throughput recovers to
    ≥ 50% of healthy within the window; invariants green."""
    report = SCENARIOS["wedged_dispatch_recovers"](11, str(tmp_path),
                                                   device="cpu")
    assert_chaos_report(report)
    assert report["tripped"], report
    assert report["wedged_dispatches"] >= 1, report
    assert report["degraded_dispatches"] >= 1, report
    assert report["crowd_drained"], report
    assert report["throughput_ratio"] >= 0.5, report
    assert report["recovered"], report
    assert any(k == "wedge" for _, k, _ in report["faults"]), report
    assert 0 < report["crowd_to_trip_s"] < report["crowd_to_trip_s"] + \
        report["trip_to_close_s"]


def test_wedged_crowd_placed_in_full_after_the_close(tmp_path):
    """With room for it, every crowd job is placed in full once the
    breaker has re-closed: the wedged and refused evals came back through
    the reaper (the port's replacement for the host twin)."""
    report = SCENARIOS["wedged_dispatch_recovers"](
        11, str(tmp_path), device="cpu", n_nodes=16)
    assert_chaos_report(report)
    assert report["placed_after_close"], report
    assert report["crowd_placed"] == 24, report
    assert report["crowd_to_placed_s"] > report["crowd_to_trip_s"], report


def test_device_slow_flapping(tmp_path):
    """A flapping ``device.slow`` seam: every dispatch places in the end
    (a refused one re-sent after the probation), and the flip budget
    bounds the oscillation."""
    report = SCENARIOS["device_slow_flapping"](7, str(tmp_path),
                                               device="cpu")
    assert_chaos_report(report)
    assert report["placed"] == 60, report
    assert report["flips"] <= report["flip_budget"], report
    assert report["slow_recorded"] >= 1, report
    assert any(k == "slow" for _, k, _ in report["faults"]), report


@pytest.mark.parametrize("seed", [5])
def test_shard_loss_evacuation_parity(tmp_path, seed):
    """A home shard lost mid-dispatch on a mesh of four node shards: the
    survivor layout equals a from-scratch one row for row, the resident
    copy a from-scratch lay-out bit for bit, the in-flight placement
    lands on the survivors' mesh, and heal restores four shards."""
    report = SCENARIOS["shard_loss_evacuation"](seed, str(tmp_path),
                                                device="cpu")
    assert_chaos_report(report)
    assert report["parity_mismatches"] == 0, report
    assert report["resident_mismatches"] == 0, report
    assert report["evacuations"] == 1, report
    assert (report["pre_shards"], report["post_shards"],
            report["restored_shards"]) == (4, 3, 4), report
    assert report["pre_placed_row"] >= 0 and report["placed_row"] >= 0
    assert report["reupload_bytes"] > 0, report
    assert any(k == "lost" for _, k, _ in report["faults"]), report
