"""TSan-lite beside the port's chaos scenarios, as ``tests/test_chaos.py``
runs it beside the reference's leader kill and flash crowd: the three
in-process server agents (stores, matrices, coalescers, brokers) are
built inside ``tsan.sanitized()``, so every declared shared object is
lockset-checked while the fault schedule widens the race windows, and
the run must end with zero race reports.

The flash crowd runs here at the smaller size of
``test_flash_crowd_flips_bounded_across_seeds`` and is held to the
sanitizer's verdict, the store's invariants and the control loop's
engagement; its recovery and goodput are timing checks, held without the
instrumentation by ``tests/test_torch_chaos_overload.py``.  It is marked
``slow`` (a three-agent cluster under the sanitizer, 14-87 s): a whole
run hands it out beside the overload file, whose recovery depends on how
fast the host admits the crowd (ROADMAP F2); run it with ``-m slow``.  A file of few tests, handed out well after
``tests/test_chaos.py`` (ROADMAP R2).
"""

import pytest
import torch

from nomad_tpu_torch.chaos.scenarios import SCENARIOS
from nomad_tpu_torch.lint import tsan
from torch_parity import assert_chaos_report

torch.set_num_threads(1)


def _races(reports):
    return "\n".join(f"{r['label']} {r['op']} in {r['thread']} "
                     f"held={r['held']}\n{r['stack']}" for r in reports)


def test_leader_kill_mid_apply_under_the_sanitizer(tmp_path):
    with tsan.sanitized():
        report = SCENARIOS["leader_kill_mid_apply"](11, str(tmp_path),
                                                    device="cpu")
        races = tsan.reports()
    assert races == [], _races(races)
    assert_chaos_report(report)
    assert any(k == "delay" for _, k, _ in report["faults"]), report
    assert report["post_kill_eval"], report


@pytest.mark.slow
def test_flash_crowd_under_the_sanitizer(tmp_path):
    with tsan.sanitized():
        report = SCENARIOS["flash_crowd_flapping_partition"](
            11, str(tmp_path), crowd=120, second_wave=40, device="cpu")
        races = tsan.reports()
    assert races == [], _races(races)
    assert_chaos_report(report)
    assert report["engaged"], report
    assert report["total_shed"] > 0 or report["rejected"] > 0, report
    assert any(k == "drop" for _, k, _ in report["faults"]), report
