"""The port's dispatch hot-path pass (``nomad_tpu_torch/lint/hotpass.py``,
H001-H003, the counterpart of the reference's J001-J005) and its
dispatch contracts (``nomad_tpu_torch/lint/contracts.py``, D001-D002) on
seeded fixtures and on the port's tree.
"""

from __future__ import annotations

import textwrap

import torch

from nomad_tpu_torch.lint import contracts, hotpass

torch.set_num_threads(1)

KERNELS = "nomad_tpu_torch/ops/kernels.py"


def _hot(src: str, path: str = KERNELS):
    return hotpass.analyze_sources({path: textwrap.dedent(src)})


def _rules(findings):
    return [f.rule for f in findings]


# ----------------------------------------------------------------------
# H001 — host sync on a device value
# ----------------------------------------------------------------------

class TestH001:
    def test_cpu_of_a_kernel_result_fires(self):
        fs = _hot("""
            def select(arrays, used, *ops):
                packed = fused_place(arrays, used, *ops)
                return packed[0].cpu().numpy()
        """)
        assert _rules(fs) == ["H001"], fs
        assert fs[0].symbol == "select" and "packed" in fs[0].message

    def test_item_on_an_upload_fires(self):
        fs = _hot("""
            def stage(a, dev):
                t = upload(a, dev)
                return t.sum().item()
        """)
        assert _rules(fs) == ["H001"], fs

    def test_int_of_a_kernel_call_fires(self):
        fs = _hot("""
            def first_row(args):
                return int(kernels.fused_place_batch(*args)[0, 0, 0])
        """)
        assert _rules(fs) == ["H001"], fs

    def test_tolist_via_a_local_hop_fires(self):
        fs = _hot("""
            def rows(args):
                out = sharded_verify(*args)
                first = out[:, 0]
                return first.tolist()
        """)
        assert _rules(fs) == ["H001"], fs

    def test_synchronize_fires(self):
        fs = _hot("""
            import torch

            def wait(args):
                out = fused_place(*args)
                torch.cuda.synchronize(out.device)
                return out
        """)
        assert _rules(fs) == ["H001"], fs

    def test_ticket_copy_is_clean(self):
        # The coalescer's one result copy: a non-blocking copy into a
        # page-locked host tensor, read after its event.
        fs = _hot("""
            import torch

            class DeviceCoalescer:
                def _dispatch(self, arrays, ops):
                    packed = kernels.fused_place_batch(arrays, *ops)
                    host = torch.empty(packed.shape, pin_memory=True)
                    host.copy_(packed, non_blocking=True)
                    return host

                def _wait_fetch(self, ticket):
                    return ticket.host.numpy()
        """, "nomad_tpu_torch/scheduler/coalescer.py")
        assert fs == [], fs

    def test_plain_version_on_host_tensors_is_clean(self):
        # A plain version's own syncs read CPU tensors it was given.
        fs = _hot("""
            def place_lanes(used, ok, row):
                for lane in torch.nonzero(ok).flatten().tolist():
                    r = int(row[lane])
                return used.cpu()
        """)
        assert fs == [], fs


# ----------------------------------------------------------------------
# H002 — node-axis fetch on a fused or sharded dispatch
# ----------------------------------------------------------------------

class TestH002:
    def test_used_fetched_on_the_fused_path_fires(self):
        fs = _hot("""
            def dispatch(arrays, ops):
                packed = fused_place_batch(arrays, arrays.used, *ops)
                snapshot = arrays.used.cpu()
                return packed, snapshot
        """)
        assert _rules(fs) == ["H002"], fs
        assert "arrays.used" in fs[0].message

    def test_node_axis_local_hop_on_the_sharded_path_fires(self):
        fs = _hot("""
            import numpy as np

            def dispatch(fn, sharded, arrays, ops):
                totals = arrays.totals
                out = fn(sharded, *ops)
                _sharded_fused_fn(sharded, *ops)
                return np.asarray(totals), out
        """, "nomad_tpu_torch/parallel/sharding.py")
        assert "H002" in _rules(fs), fs

    def test_packed_winner_fetch_is_clean(self):
        fs = _hot("""
            def dispatch(arrays, ops, host):
                packed = fused_place_batch(arrays, arrays.used, *ops)
                host.copy_(packed, non_blocking=True)
                n = int(arrays.used.shape[0])
                return host, n
        """)
        assert fs == [], fs

    def test_node_fetch_off_the_fused_path_is_not_h002(self):
        fs = _hot("""
            def debug_dump(arrays):
                return arrays.used.cpu()
        """)
        assert "H002" not in _rules(fs), fs


# ----------------------------------------------------------------------
# H003 — module-level mutable tensor captured by a launch
# ----------------------------------------------------------------------

class TestH003:
    def test_launch_reading_a_module_tensor_fires(self):
        fs = _hot("""
            import torch

            _SCRATCH = torch.zeros((64, 8))

            def fused_place(arrays, used, *ops):
                fn = _entry("fused_place", "fused_place")
                fn(_SCRATCH.data_ptr(), used.data_ptr())
        """)
        assert _rules(fs) == ["H003"], fs
        assert "_SCRATCH" in fs[0].message

    def test_launch_helper_counts_as_a_launch(self):
        fs = _hot("""
            import torch

            _OUT = torch.empty((4,))

            def wrapper(arrays):
                return _launch_fused_place("fused_place", arrays, _OUT)
        """)
        assert _rules(fs) == ["H003"], fs

    def test_per_launch_allocation_is_clean(self):
        fs = _hot("""
            import torch

            LIMIT = 1024

            def fused_place(arrays, used, b):
                out = torch.empty((b, LIMIT))
                fn = _entry("fused_place", "fused_place")
                fn(out.data_ptr(), used.data_ptr())
                return out
        """)
        assert fs == [], fs

    def test_module_tensor_outside_a_launch_is_clean(self):
        fs = _hot("""
            import torch

            _TABLE = torch.arange(8)

            def lookup(i):
                return _TABLE[i]
        """)
        assert fs == [], fs


# ----------------------------------------------------------------------
# The port's tree
# ----------------------------------------------------------------------

def test_port_tree_is_clean_against_its_baseline():
    from nomad_tpu_torch.lint import load_baseline, repo_root, split_baselined

    findings = hotpass.run(repo_root())
    new, suppressed, _ = split_baselined(findings, load_baseline())
    assert new == [], [f.render() for f in new]
    # The one exemption: the solo path's own result copy.
    assert [(f.rule, f.symbol) for f in suppressed] == [
        ("H001", "place_task_group")]


# ----------------------------------------------------------------------
# D001/D002 — dispatch contracts on the CPU
# ----------------------------------------------------------------------

class TestContracts:
    def test_every_row_holds_on_the_cpu(self):
        assert contracts.run() == []
        assert [c.name for c in contracts.table()] == [
            "fused_place_batch", "place_batch", "sharded_fused_place_batch"]

    def test_results_are_the_packed_blocks(self):
        g = contracts.GRID
        for c in contracts.table():
            for n in (contracts.N_A, contracts.N_B):
                out = c.call(g._replace(nodes=n))
                assert out.shape[:2] == (g.batch, g.placements)
                assert out.numel() * out.element_size() == c.out_budget(g)

    def test_node_shaped_result_fires_d001(self):
        row = contracts.DispatchContract(
            name="leaky", path=KERNELS,
            call=lambda g: torch.zeros((g.batch, g.nodes)),
            out_budget=lambda g: 10 ** 9)
        fs = contracts.check(row)
        assert [f.rule for f in fs] == ["D001"], fs
        assert fs[0].symbol == "leaky"

    def test_result_over_budget_fires_d002(self):
        row = contracts.DispatchContract(
            name="fat", path=KERNELS,
            call=lambda g: torch.zeros((g.batch, g.placements, 16)),
            out_budget=lambda g: g.batch * g.placements * 8 * 4)
        fs = contracts.check(row)
        assert [f.rule for f in fs] == ["D002"], fs

    def test_fixed_block_within_budget_is_clean(self):
        row = contracts.DispatchContract(
            name="ok", path=KERNELS,
            call=lambda g: torch.zeros((g.batch, g.placements, 8)),
            out_budget=lambda g: g.batch * g.placements * 8 * 4)
        assert contracts.check(row) == []
