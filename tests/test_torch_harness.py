"""The port's scheduler ``Harness`` against the reference's, on the CPU.

Cases taken from ``tests/test_scheduler.py`` run through
``nomad_tpu_torch.scheduler.testing.Harness(device="cpu")`` and the JAX
package's ``Harness`` on the same fixed-id nodes and jobs; every plan
(placements by node and alloc name, stops with their statuses,
preemptions), every eval update and every created eval must agree.
"""

import types as pytypes

import pytest
import torch

torch.set_num_threads(1)


def _pkg(name):
    if name == "jax":
        from nomad_tpu import mock
        from nomad_tpu.scheduler import GenericScheduler, SystemScheduler
        from nomad_tpu.scheduler.testing import Harness
        from nomad_tpu.structs import types

        return pytypes.SimpleNamespace(
            mock=mock, t=types, Generic=GenericScheduler,
            System=SystemScheduler, harness=Harness)
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import GenericScheduler, SystemScheduler
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import types

    return pytypes.SimpleNamespace(
        mock=mock, t=types, Generic=GenericScheduler, System=SystemScheduler,
        harness=lambda: Harness(device="cpu"))


def service(P):
    def factory(snapshot, planner, matrix):
        return P.Generic("service", snapshot, planner, matrix)
    return factory


def system(P):
    def factory(snapshot, planner, matrix):
        return P.System(snapshot, planner, matrix)
    return factory


def node(P, h, i, **kw):
    n = P.mock.node(**kw)
    n.id = n.name = f"node-{i}"
    h.store.upsert_node(h.next_index(), n)
    return n


def job(P, name, **kw):
    j = P.mock.job(**kw)
    j.id = j.name = name
    return j


def register(P, h, j):
    h.store.upsert_job(h.next_index(), j)
    return P.mock.eval_for(j)


# -- cases (tests/test_scheduler.py) -----------------------------------------


def case_register_places_all(P, h):
    for i in range(10):
        node(P, h, i)
    j = job(P, "web")
    h.process(service(P), register(P, h, j))


def case_binpack_prefers_packed_node(P, h):
    n1, _ = node(P, h, 1), node(P, h, 2)
    j0 = job(P, "pre")
    a0 = P.mock.alloc(j0, n1)
    h.store.upsert_job(h.next_index(), j0)
    h.store.upsert_allocs(h.next_index(), [a0])
    j = job(P, "web")
    j.task_groups[0].count = 1
    h.process(service(P), register(P, h, j))


def case_insufficient_capacity_blocks(P, h):
    small = P.mock.node()
    small.id = small.name = "small"
    small.resources.cpu = 600
    small.resources.memory_mb = 700
    h.store.upsert_node(h.next_index(), small)
    j = job(P, "web")
    j.task_groups[0].count = 3
    h.process(service(P), register(P, h, j))


def case_constraint_filters_nodes(P, h):
    good, bad = node(P, h, 1), node(P, h, 2)
    good.attributes["os.name"] = "ubuntu"
    bad.attributes["os.name"] = "centos"
    h.store.upsert_node(h.next_index(), good)
    h.store.upsert_node(h.next_index(), bad)
    j = job(P, "web")
    j.task_groups[0].count = 2
    j.constraints.append(P.t.Constraint(
        l_target="${attr.os.name}", operand=P.t.Op.EQ.value,
        r_target="ubuntu"))
    h.process(service(P), register(P, h, j))


def case_distinct_hosts(P, h):
    for i in range(3):
        node(P, h, i)
    j = job(P, "web")
    j.task_groups[0].count = 3
    j.constraints.append(P.t.Constraint(operand=P.t.Op.DISTINCT_HOSTS.value))
    h.process(service(P), register(P, h, j))


def case_update_in_place_then_destructive(P, h):
    node(P, h, 1)
    j = job(P, "web")
    j.task_groups[0].count = 2
    h.process(service(P), register(P, h, j))
    j2 = j.copy()
    j2.task_groups[0].count = 3
    h.process(service(P), register(P, h, j2))
    j3 = j2.copy()
    j3.task_groups[0].tasks[0].resources = P.t.Resources(cpu=700,
                                                         memory_mb=512)
    h.process(service(P), register(P, h, j3))


def case_deregister_stops_allocs(P, h):
    node(P, h, 1)
    j = job(P, "web")
    j.task_groups[0].count = 2
    h.process(service(P), register(P, h, j))
    j2 = j.copy()
    j2.stop = True
    h.process(service(P), register(P, h, j2))


def case_node_down_reschedules_lost(P, h):
    node(P, h, 1)
    node(P, h, 2)
    j = job(P, "web")
    j.task_groups[0].count = 1
    h.process(service(P), register(P, h, j))
    first = h.store.allocs_by_job(j.namespace, j.id)[0]
    h.store.update_node_status(h.next_index(), first.node_id,
                               P.t.NodeStatus.DOWN.value)
    h.process(service(P), P.mock.eval_for(j))


def case_system_job_every_feasible_node(P, h):
    for i in range(5):
        node(P, h, i)
    other = P.mock.node(datacenter="dc9")
    other.id = other.name = "node-dc9"
    h.store.upsert_node(h.next_index(), other)
    j = P.mock.system_job()
    j.id = j.name = "sys"
    h.process(system(P), register(P, h, j))


def case_preemption_evicts_lower_priority(P, h):
    n = P.mock.node()
    n.id = n.name = "only"
    n.resources.cpu = 1100
    n.resources.memory_mb = 1280
    h.store.upsert_node(h.next_index(), n)
    h.store.set_scheduler_config(h.next_index(), P.t.SchedulerConfiguration(
        preemption_config=P.t.PreemptionConfig(
            service_scheduler_enabled=True)))
    for name, prio in (("low", 20), ("high", 80)):
        j = job(P, name, priority=prio)
        j.task_groups[0].count = 1
        j.task_groups[0].tasks[0].resources = P.t.Resources(cpu=800,
                                                            memory_mb=512)
        h.process(service(P), register(P, h, j))


def case_spread_balances(P, h):
    i = 0
    for dc in ("dc1", "dc2"):
        for _ in range(2):
            node(P, h, i, datacenter=dc)
            i += 1
    j = job(P, "web", datacenters=["dc1", "dc2"])
    j.task_groups[0].count = 4
    j.spreads = [P.t.Spread(attribute="${node.datacenter}", weight=100)]
    h.process(service(P), register(P, h, j))


def case_reject_plan_refreshes(P, h):
    """RejectPlan: every plan refused, the scheduler refreshes and fails
    after its attempts."""
    for i in range(3):
        node(P, h, i)
    h.reject_plan = True
    j = job(P, "web")
    j.task_groups[0].count = 2
    h.process(service(P), register(P, h, j))


CASES = {f.__name__[len("case_"):]: f for f in (
    case_register_places_all,
    case_binpack_prefers_packed_node,
    case_insufficient_capacity_blocks,
    case_constraint_filters_nodes,
    case_distinct_hosts,
    case_update_in_place_then_destructive,
    case_deregister_stops_allocs,
    case_node_down_reschedules_lost,
    case_system_job_every_feasible_node,
    case_preemption_evicts_lower_priority,
    case_spread_balances,
    case_reject_plan_refreshes,
)}


def record(h):
    """Every plan, eval update and created eval, without ids or times."""
    def allocs(d, *fields):
        return sorted((nid, a.name) + tuple(getattr(a, f) for f in fields)
                      for nid, lst in d.items() for a in lst)

    plans = [dict(
        place=allocs(p.node_allocation, "desired_status"),
        stop=allocs(p.node_update, "desired_status", "client_status"),
        preempt=allocs(p.node_preemptions, "desired_status"),
    ) for p in h.plans]
    evals = [(e.status, e.triggered_by, sorted(
        (e.queued_allocations or {}).items()), bool(e.blocked_eval))
        for e in h.evals]
    created = sorted((e.status, e.triggered_by) for e in h.created_evals)
    stored = sorted((a.name, a.node_id, a.desired_status, a.client_status)
                    for a in h.store.allocs.values())
    return dict(plans=plans, evals=evals, created=created, stored=stored)


@pytest.mark.parametrize("name", sorted(CASES))
def test_harness_plans_equal_the_references(name):
    got = {}
    for pkg in ("jax", "port"):
        P = _pkg(pkg)
        h = P.harness()
        CASES[name](P, h)
        got[pkg] = record(h)
    if name == "reject_plan_refreshes":
        # A deliberate difference (ROADMAP R4): an eval that fails its
        # plan attempts leaves a blocked retry in the port, none in the
        # reference.
        port, ref = got["port"], got["jax"]
        assert port["created"] == [("blocked", "max-plan-attempts")]
        assert ref["created"] == []
        assert [e[:3] for e in port["evals"]] == [e[:3] for e in ref["evals"]]
        assert port["plans"] == ref["plans"]
        assert port["stored"] == ref["stored"] == []
        return
    assert got["port"] == got["jax"]
    assert got["port"]["plans"], "the case made no plan"


def test_harness_defaults_to_the_card():
    """Without a store the harness's matrix asks for ``"cuda"``; with no
    card its first select raises rather than running on the CPU."""
    from nomad_tpu_torch.scheduler.testing import Harness

    h = Harness()
    assert h.store.matrix.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            h.store.matrix.sync()
