"""The port's replication chaos scenarios on the CPU: three in-process
server agents on loopback HTTP, at the reference's seeds
(``tests/test_chaos.py``).  A file of few tests, handed out well after
``tests/test_chaos.py`` (ROADMAP R2).  The reference runs TSan-lite
beside ``leader_kill_mid_apply``; the port runs it beside its own in
``tests/test_torch_chaos_tsan.py``.
"""

import pytest
import torch

from nomad_tpu_torch.chaos.scenarios import SCENARIOS
from torch_parity import assert_chaos_report

torch.set_num_threads(1)


def test_leader_kill_mid_apply(tmp_path):
    report = SCENARIOS["leader_kill_mid_apply"](11, str(tmp_path),
                                                device="cpu")
    assert_chaos_report(report)
    # The delay schedule actually widened the window.
    assert any(k == "delay" for _, k, _ in report["faults"]), report
    assert report["post_kill_eval"], report


def test_partition_then_heal(tmp_path):
    report = SCENARIOS["partition_then_heal"](3, str(tmp_path), device="cpu")
    assert_chaos_report(report)
    drops = [f for f in report["faults"] if f[1] == "drop"]
    assert len(drops) == report["drops"]


def test_partition_schedule_replays_from_seed(tmp_path):
    """Same seed → same drop budget and the same fired-fault schedule
    (count-triggered: every fired fault is ("raft.send", "drop"), and
    exactly `drops` of them fire in both runs)."""
    r1 = SCENARIOS["partition_then_heal"](3, str(tmp_path / "a"),
                                          device="cpu")
    r2 = SCENARIOS["partition_then_heal"](3, str(tmp_path / "b"),
                                          device="cpu")
    assert r1["drops"] == r2["drops"]
    assert [(s, k) for s, k, _ in r1["faults"]] == \
        [(s, k) for s, k, _ in r2["faults"]]
    assert r1["violations"] == r2["violations"] == []


@pytest.mark.slow
@pytest.mark.parametrize("seed", [1, 2, 4, 8])
def test_partition_seed_matrix(tmp_path, seed):
    report = SCENARIOS["partition_then_heal"](seed, str(tmp_path),
                                              device="cpu")
    assert_chaos_report(report)
