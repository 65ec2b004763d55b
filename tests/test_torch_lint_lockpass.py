"""The port's lock-discipline pass (``nomad_tpu_torch/lint/lockpass.py``,
L001-L004) on seeded fixtures, as ``tests/test_lint.py`` holds the
reference's: each rule fires on a minimal fixture and stays quiet on the
matching clean idiom.  The port's own hierarchy (``lint/lock_order.py``:
``_stream_lock`` → ``_write_lock`` → replication ``_lock`` →
``_lock``) and its device waits (``.cpu()``/``.item()``/``.tolist()``/
``synchronize``) have cases of their own, and the pass is clean on the
port's tree against the committed baseline.

Fixture paths matter: lock resolution keys on the repo-relative module
suffix (``lock_order.ALIASES``), so fixtures masquerade as the real
modules they exercise rules against.
"""

from __future__ import annotations

import textwrap

import pytest

from nomad_tpu_torch.lint import lockpass


def _lock_findings(src: str, path: str = "nomad_tpu_torch/state/matrix.py"):
    return lockpass.analyze_sources({path: textwrap.dedent(src)})


def _rules(findings):
    return [f.rule for f in findings]


class TestL001:
    def test_direct_inversion_fires(self):
        fs = _lock_findings(
            """
            class NodeMatrix:
                def bad(self):
                    with self._host_lock:
                        with DEVICE_LOCK:
                            pass
            """
        )
        assert "L001" in _rules(fs), fs

    def test_declared_order_is_clean(self):
        fs = _lock_findings(
            """
            class NodeMatrix:
                def good(self):
                    with DEVICE_LOCK:
                        with self._host_lock:
                            pass
            """
        )
        assert "L001" not in _rules(fs), fs

    def test_inversion_via_call_fires(self):
        # bad() holds matrix.host and calls a method whose body acquires
        # the device lock — the one-level interprocedural walk sees it.
        fs = _lock_findings(
            """
            class NodeMatrix:
                def _grab_device(self):
                    with DEVICE_LOCK:
                        pass

                def bad(self):
                    with self._host_lock:
                        self._grab_device()
            """
        )
        assert "L001" in _rules(fs), fs

    def test_reentrant_reacquire_is_clean(self):
        # install_snapshot's shape: the outer frame already holds the
        # (reentrant) outermost lock; a callee re-acquiring it adds no
        # ordering edge.
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/state/store.py": textwrap.dedent(
                """
                class StateStore:
                    def _inner(self):
                        with self._write_lock:
                            pass

                    def ok(self):
                        with self._write_lock, self._lock:
                            self._inner()
                """
            )
        })
        assert "L001" not in _rules(fs), fs


# ----------------------------------------------------------------------
# L002 — Condition.wait while holding a foreign lock
# ----------------------------------------------------------------------

class TestL002:
    def test_wait_with_foreign_lock_fires(self):
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/state/store.py": textwrap.dedent(
                """
                class StateStore:
                    def bad(self):
                        with self._lock:
                            with self._watch_cond:
                                self._watch_cond.wait()
                """
            )
        })
        assert "L002" in _rules(fs), fs

    def test_wait_on_own_condvar_is_clean(self):
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/state/store.py": textwrap.dedent(
                """
                class StateStore:
                    def good(self):
                        with self._watch_cond:
                            self._watch_cond.wait()
                """
            )
        })
        assert "L002" not in _rules(fs), fs


# ----------------------------------------------------------------------
# L003 — blocking call inside a critical section
# ----------------------------------------------------------------------

class TestL003:
    def test_sleep_under_lock_fires(self):
        fs = _lock_findings(
            """
            import time

            class NodeMatrix:
                def bad(self):
                    with self._host_lock:
                        time.sleep(0.1)
            """
        )
        assert "L003" in _rules(fs), fs

    def test_sleep_outside_lock_is_clean(self):
        fs = _lock_findings(
            """
            import time

            class NodeMatrix:
                def good(self):
                    with self._host_lock:
                        pass
                    time.sleep(0.1)
            """
        )
        assert "L003" not in _rules(fs), fs

    def test_device_fetch_under_lock_fires(self):
        fs = _lock_findings(
            """
            class NodeMatrix:
                def bad(self, x):
                    with self._host_lock:
                        return x.cpu()
            """
        )
        assert "L003" in _rules(fs), fs

    def test_device_ops_under_device_lock_are_exempt(self):
        # Copying the matrix to the card under DEVICE_LOCK is that lock's
        # purpose.
        fs = _lock_findings(
            """
            class NodeMatrix:
                def good(self):
                    with DEVICE_LOCK:
                        self.sync()
            """
        )
        assert "L003" not in _rules(fs), fs


# ----------------------------------------------------------------------
# L004 — literal-bounded condvar wait
# ----------------------------------------------------------------------

class TestL004:
    def test_literal_timeout_fires(self):
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/state/store.py": textwrap.dedent(
                """
                class StateStore:
                    def bad(self):
                        with self._watch_cond:
                            self._watch_cond.wait(0.2)
                """
            )
        })
        assert "L004" in _rules(fs), fs

    def test_literal_via_ifexp_assignment_fires(self):
        # The exact coalescer._next_batch shape this rule was built for.
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/state/store.py": textwrap.dedent(
                """
                class StateStore:
                    def bad(self):
                        with self._watch_cond:
                            timeout = 0.2 if self.busy else None
                            self._watch_cond.wait_for(lambda: True, timeout=timeout)
                """
            )
        })
        assert "L004" in _rules(fs), fs

    def test_untimed_wait_is_clean(self):
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/state/store.py": textwrap.dedent(
                """
                class StateStore:
                    def good(self):
                        with self._watch_cond:
                            self._watch_cond.wait()
                """
            )
        })
        assert "L004" not in _rules(fs), fs

    def test_parameter_timeout_is_clean(self):
        # Caller-supplied deadlines (wait_for_index) are an API contract,
        # not a lost-notify workaround.
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/state/store.py": textwrap.dedent(
                """
                class StateStore:
                    def good(self, timeout=None):
                        with self._watch_cond:
                            self._watch_cond.wait(timeout)
                """
            )
        })
        assert "L004" not in _rules(fs), fs


# ----------------------------------------------------------------------
# The port's own hierarchy and device waits
# ----------------------------------------------------------------------

class TestPortOrder:
    def test_apply_remote_order_is_clean(self):
        # StateStore.apply_remote takes _write_lock before _lock (ROADMAP
        # "Drops", state/store.py): the declared order.
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/state/store.py": textwrap.dedent(
                """
                class StateStore:
                    def apply_remote(self, entry):
                        with self._write_lock:
                            with self._lock:
                                pass
                """
            )
        })
        assert "L001" not in _rules(fs), fs

    def test_state_lock_then_write_lock_fires(self):
        # The reference's inverted shape: _lock held, then _write_lock.
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/state/store.py": textwrap.dedent(
                """
                class StateStore:
                    def bad(self):
                        with self._lock:
                            with self._write_lock:
                                pass
                """
            )
        })
        assert "L001" in _rules(fs), fs

    def test_stream_lock_is_outermost(self):
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/server/replication.py": textwrap.dedent(
                """
                class Replicator:
                    def handle_append(self, body):
                        with self._stream_lock:
                            with self._lock:
                                pass
                            self.server.store.apply_remote(body)
                """
            )
        })
        assert fs == [], fs

    def test_stream_lock_under_replication_lock_fires(self):
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/server/replication.py": textwrap.dedent(
                """
                class Replicator:
                    def bad(self):
                        with self._lock:
                            with self._stream_lock:
                                pass
                """
            )
        })
        assert "L001" in _rules(fs), fs

    def test_write_lock_under_stream_lock_via_call_is_clean(self):
        fs = lockpass.analyze_sources({
            "nomad_tpu_torch/server/replication.py": textwrap.dedent(
                """
                class Replicator:
                    def good(self):
                        with self._stream_lock:
                            self.store.apply_remote({})
                """
            ),
            "nomad_tpu_torch/state/store.py": textwrap.dedent(
                """
                class StateStore:
                    def apply_remote(self, entry):
                        with self._write_lock:
                            with self._lock:
                                pass
                """
            ),
        })
        assert "L001" not in _rules(fs), fs

    @pytest.mark.parametrize("wait", ["x.item()", "x.tolist()",
                                      "torch.cuda.synchronize()",
                                      "stream.synchronize()"])
    def test_device_waits_under_lock_fire(self, wait):
        fs = _lock_findings(
            f"""
            class NodeMatrix:
                def bad(self, x, stream):
                    with self._host_lock:
                        return {wait}
            """
        )
        assert "L003" in _rules(fs), fs

    def test_sync_sharded_under_device_lock_is_exempt(self):
        fs = _lock_findings(
            """
            class DeviceCoalescer:
                def _sync(self):
                    with DEVICE_LOCK:
                        return self.matrix.sync_sharded(self._mesh)
            """
        )
        assert fs == [], fs

    def test_port_tree_is_clean_against_its_baseline(self):
        from nomad_tpu_torch.lint import (
            load_baseline,
            repo_root,
            split_baselined,
        )

        new, _suppressed, _stale = split_baselined(
            lockpass.run(repo_root()), load_baseline())
        assert new == [], [f.render() for f in new]
