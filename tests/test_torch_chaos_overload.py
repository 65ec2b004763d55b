"""The port's overload chaos scenarios on the CPU: a three-agent cluster
under a flash crowd with a flapping link, and a leader killed while it
sheds, at the reference's seeds (``tests/test_chaos.py``).  A file of few
tests, handed out well after ``tests/test_chaos.py`` (ROADMAP R2).  The
reference runs TSan-lite beside the flash crowd; the port runs it beside
its own in ``tests/test_torch_chaos_tsan.py``.
"""

import pytest
import torch

from nomad_tpu_torch.chaos.scenarios import SCENARIOS
from torch_parity import assert_chaos_report

torch.set_num_threads(1)


def test_flash_crowd_flapping_partition(tmp_path):
    """Shedding engages within one fast pressure window of the crowd,
    goodput holds ≥ 50% of the pre-overload rate while shedding, evals
    are shed, and the controller returns to steady inside its flip
    budget, with the leader→follower link flapping."""
    report = SCENARIOS["flash_crowd_flapping_partition"](
        11, str(tmp_path), device="cpu")
    assert_chaos_report(report)
    assert report["engaged"], report
    assert report["time_to_engage_s"] <= report["fast_window_s"] + 4.0
    assert report["state_under_load"] in ("gating", "shedding")
    assert report["rejected"] > 0, report
    assert report["total_shed"] > 0, report
    assert report["goodput_ratio"] >= 0.5, report
    assert report["recovered"], report
    assert report["flips"] <= report["flip_budget"], report
    assert any(k == "drop" for _, k, _ in report["faults"]), report


@pytest.mark.parametrize("seed", [3, 23])
def test_flash_crowd_flips_bounded_across_seeds(tmp_path, seed):
    report = SCENARIOS["flash_crowd_flapping_partition"](
        seed, str(tmp_path), crowd=120, second_wave=40, device="cpu")
    assert_chaos_report(report)
    assert report["flips"] <= report["flip_budget"], report
    assert report["recovered"], report


def test_breach_while_leader_killed(tmp_path):
    report = SCENARIOS["breach_while_leader_killed"](7, str(tmp_path),
                                                     device="cpu")
    assert_chaos_report(report)
    assert report["engaged_pre_kill"], report
    assert report["old_leader_released"], report
    assert report["post_kill_eval"], report
    assert report["recovered"], report
    assert report["new_leader_flips"] <= report["flip_budget"], report
