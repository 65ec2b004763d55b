"""Scheduling kernels — plain PyTorch versions and the CUDA kernel wrappers.

Each function is the counterpart of the JAX package's ``ops/kernels.py``
function of the same name, with the same score semantics (reference
comments there):

  binpack     = ScoreFitBinPack/18           (funcs.go:186, rank.go:513)
  anti-aff    = -(collisions+1)/desired      (rank.go:601-607, only if >0)
  penalty     = -1 on penalized nodes        (rank.go:646, only if penalized)
  affinity    = Σ weight·match / Σ|weight|   (rank.go:704-728, only if ≠0)
  spread      = per-stanza boosts            (spread.go:110-178, only if ≠0)
  preemption  = logistic(netPriority)        (rank.go:773-844, only if used)
  final       = mean of appended components  (rank.go:737-771)

``vmap`` over eval lanes is written out: every lane-dependent tensor has a
leading ``B`` axis, and the request travels packed as two ``(B, ·)``
tensors (:func:`pack_requests`), the layout the CUDA kernels read.  The
``lax.scan`` over placements is a Python loop here (the plain version) and
a loop inside each lane's thread-block cluster on the card
(``csrc/fused_place.cu``).

On a CPU tensor the wrappers :func:`fused_place`,
:func:`allocs_fit_verify`, :func:`system_feasible`, :func:`score_batch`,
:func:`verify_plan_fit` and :func:`sharded_place` run the plain version;
on a CUDA tensor they launch the hand-written kernel, on that tensor's
card, or raise.
Sums over the small slot axes are written as ordered loops so the plain
version, the kernel and XLA add in the same order.
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..state.matrix import (
    DEVICE_SLOTS,
    DYN_PORT_CAPACITY,
    PRIORITY_BUCKETS,
    DeviceArrays,
)
from .encode import (
    MAX_AFFINITIES,
    MAX_CONSTRAINTS,
    MAX_DATACENTERS,
    MAX_SPREAD_VALUES,
    MAX_SPREADS,
    MAX_STATIC_PORTS,
    OP_GT,
    OP_GTE,
    OP_IS_NOT_SET,
    OP_IS_SET,
    OP_LT,
    OP_LTE,
    OP_NEQ,
    OP_VER_EQ,
    OP_VER_GT,
    OP_VER_GTE,
    OP_VER_LT,
    OP_VER_LTE,
    SchedRequest,
    pow2_bucket,
)

NEG_INF = -1e30

# Preemption score constants (reference: rank.go preemptionScore).
PREEMPTION_RATE = 0.0048
PREEMPTION_ORIGIN = 2048.0

# 10**x is computed as exp2(x·log₂10), as the JAX kernel does.
LOG2_10 = 3.321928094887362
# XLA rewrites ``x / 18.0`` as ``x * (1/18)`` in float32; the port
# multiplies by the same float32 reciprocal so the scores round alike.
INV_18 = float(np.float32(1.0 / 18.0))


# ---------------------------------------------------------------------------
# Static feature occupancy (per-dispatch work bounds)
# ---------------------------------------------------------------------------


class Features(NamedTuple):
    """Per-dispatch work bounds, derived from *batch occupancy*.

    The request encoding pads every dispatch to worst-case widths
    (16 constraints, 8 affinities, 2 spreads, preemption tables, port
    bitmaps); ``Features`` bounds the loops to what the batch uses.
    Widths are pow2-bucketed and the dispatcher ratchets them with
    :meth:`widen`, as the JAX package does for its compile cache; here
    they are plain loop bounds passed to the kernel.
    """

    c_width: int = MAX_CONSTRAINTS  # active constraint slots (pow2, 0..16)
    a_width: int = MAX_AFFINITIES  # active affinity slots (pow2, 0..8)
    s_width: int = MAX_SPREADS  # active spread stanzas (0..2)
    preempt: bool = True  # any eval has preemption enabled
    ports: bool = True  # any eval asks for static/dynamic ports

    def widen(self, other: "Features") -> "Features":
        """Monotone union — the dispatcher's ratchet."""
        return Features(
            c_width=max(self.c_width, other.c_width),
            a_width=max(self.a_width, other.a_width),
            s_width=max(self.s_width, other.s_width),
            preempt=self.preempt or other.preempt,
            ports=self.ports or other.ports,
        )


FULL_FEATURES = Features()


def _slot_width(slots, max_width: int) -> int:
    """Last active slot index + 1 over a (..., W) slot array. Spread slots
    are positional (an escaped stanza leaves a -1 hole), so occupancy is
    the last-used index, not the active count."""
    s = np.asarray(slots).reshape(-1, max_width)
    active = s >= 0
    if not active.any():
        return 0
    return int(np.max(np.where(active, np.arange(max_width)[None, :], -1))) + 1


def features_of(reqs: SchedRequest) -> Features:
    """Measure a numpy request (or a stacked batch of requests) into a
    bucketed :class:`Features`."""
    c_w = _slot_width(reqs.c_slot, MAX_CONSTRAINTS)
    a_w = _slot_width(reqs.a_slot, MAX_AFFINITIES)
    return Features(
        c_width=min(MAX_CONSTRAINTS, pow2_bucket(c_w)) if c_w else 0,
        a_width=min(MAX_AFFINITIES, pow2_bucket(a_w)) if a_w else 0,
        s_width=_slot_width(reqs.s_slot, MAX_SPREADS),
        preempt=bool(np.any(np.asarray(reqs.preempt_bucket) >= 0)),
        ports=bool(
            np.any(np.asarray(reqs.p_static) >= 0)
            or np.any(np.asarray(reqs.p_dyn) > 0)
        ),
    )


# ---------------------------------------------------------------------------
# Packed request layout (the kernels' ABI)
# ---------------------------------------------------------------------------

# (field, width) in packing order.  Integer and bool fields go to the int32
# tensor, float fields to the float32 tensor.  csrc/fused_place.cu reads the
# same offsets; the wrapper checks them against the library at load.
REQ_INT_FIELDS: Tuple[Tuple[str, int], ...] = (
    ("c_slot", MAX_CONSTRAINTS),
    ("c_op", MAX_CONSTRAINTS),
    ("c_hash", MAX_CONSTRAINTS),
    ("dc_hash", MAX_DATACENTERS),
    ("dev_ask", DEVICE_SLOTS),
    ("algorithm", 1),
    ("a_slot", MAX_AFFINITIES),
    ("a_op", MAX_AFFINITIES),
    ("a_hash", MAX_AFFINITIES),
    ("s_slot", MAX_SPREADS),
    ("s_even", MAX_SPREADS),
    ("s_value_hash", MAX_SPREADS * MAX_SPREAD_VALUES),
    ("preempt_bucket", 1),
    ("distinct_hosts", 1),
    ("p_static", MAX_STATIC_PORTS),
    ("p_dyn", 1),
)
REQ_FLOAT_FIELDS: Tuple[Tuple[str, int], ...] = (
    ("ask", 3),
    ("c_num", MAX_CONSTRAINTS),
    ("desired_count", 1),
    ("a_num", MAX_AFFINITIES),
    ("a_weight", MAX_AFFINITIES),
    ("s_weight", MAX_SPREADS),
    ("s_desired", MAX_SPREADS * MAX_SPREAD_VALUES),
    ("s_implicit", MAX_SPREADS),
    ("s_sum_weights", 1),
)


def _offsets(fields) -> dict:
    out, off = {}, 0
    for name, width in fields:
        out[name] = (off, width)
        off += width
    return out


REQ_INT_OFF = _offsets(REQ_INT_FIELDS)
REQ_FLOAT_OFF = _offsets(REQ_FLOAT_FIELDS)
REQ_INT_WIDTH = sum(w for _, w in REQ_INT_FIELDS)
REQ_FLOAT_WIDTH = sum(w for _, w in REQ_FLOAT_FIELDS)


def pack_requests(reqs: SchedRequest) -> Tuple[np.ndarray, np.ndarray]:
    """A stacked numpy request ((B, …) per field) as the packed
    ``(B, REQ_INT_WIDTH)`` int32 and ``(B, REQ_FLOAT_WIDTH)`` float32
    arrays the kernels take."""
    b = np.asarray(reqs.ask).shape[0]
    ints = np.concatenate(
        [np.asarray(getattr(reqs, f)).reshape(b, -1).astype(np.int32)
         for f, _ in REQ_INT_FIELDS], axis=1)
    floats = np.concatenate(
        [np.asarray(getattr(reqs, f)).reshape(b, -1).astype(np.float32)
         for f, _ in REQ_FLOAT_FIELDS], axis=1)
    assert ints.shape[1] == REQ_INT_WIDTH
    assert floats.shape[1] == REQ_FLOAT_WIDTH
    return ints, floats


def pack_request(req: SchedRequest, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One numpy request as the packed ``(1, REQ_INT_WIDTH)`` int32 and
    ``(1, REQ_FLOAT_WIDTH)`` float32 tensors on ``device`` (B=1)."""
    ri, rf = pack_requests(SchedRequest(*[np.asarray(f)[None] for f in req]))
    return torch.from_numpy(ri).to(device), torch.from_numpy(rf).to(device)


class LaneRequest(NamedTuple):
    """Per-lane request views (leading B axis) over the packed tensors."""

    ask: torch.Tensor  # (B, 3) f32
    c_slot: torch.Tensor  # (B, C) i32
    c_op: torch.Tensor
    c_hash: torch.Tensor
    c_num: torch.Tensor  # (B, C) f32
    dc_hash: torch.Tensor  # (B, DC) i32
    dev_ask: torch.Tensor  # (B, D) i32
    algorithm: torch.Tensor  # (B,) i32
    desired_count: torch.Tensor  # (B,) f32
    a_slot: torch.Tensor
    a_op: torch.Tensor
    a_hash: torch.Tensor
    a_num: torch.Tensor
    a_weight: torch.Tensor
    s_slot: torch.Tensor  # (B, S) i32
    s_weight: torch.Tensor  # (B, S) f32
    s_even: torch.Tensor  # (B, S) bool
    s_value_hash: torch.Tensor  # (B, S, V) i32
    s_desired: torch.Tensor  # (B, S, V) f32
    s_implicit: torch.Tensor  # (B, S) f32
    s_sum_weights: torch.Tensor  # (B,) f32
    preempt_bucket: torch.Tensor  # (B,) i32
    distinct_hosts: torch.Tensor  # (B,) bool
    p_static: torch.Tensor  # (B, P) i32
    p_dyn: torch.Tensor  # (B,) i32


def unpack_requests(req_i: torch.Tensor, req_f: torch.Tensor) -> LaneRequest:
    """Views of the packed request tensors by field."""
    b = req_i.shape[0]

    def geti(name):
        off, w = REQ_INT_OFF[name]
        return req_i[:, off:off + w]

    def getf(name):
        off, w = REQ_FLOAT_OFF[name]
        return req_f[:, off:off + w]

    sv = (b, MAX_SPREADS, MAX_SPREAD_VALUES)
    return LaneRequest(
        ask=getf("ask"),
        c_slot=geti("c_slot"),
        c_op=geti("c_op"),
        c_hash=geti("c_hash"),
        c_num=getf("c_num"),
        dc_hash=geti("dc_hash"),
        dev_ask=geti("dev_ask"),
        algorithm=geti("algorithm")[:, 0],
        desired_count=getf("desired_count")[:, 0],
        a_slot=geti("a_slot"),
        a_op=geti("a_op"),
        a_hash=geti("a_hash"),
        a_num=getf("a_num"),
        a_weight=getf("a_weight"),
        s_slot=geti("s_slot"),
        s_weight=getf("s_weight"),
        s_even=geti("s_even") != 0,
        s_value_hash=geti("s_value_hash").reshape(sv),
        s_desired=getf("s_desired").reshape(sv),
        s_implicit=getf("s_implicit"),
        s_sum_weights=getf("s_sum_weights")[:, 0],
        preempt_bucket=geti("preempt_bucket")[:, 0],
        distinct_hosts=geti("distinct_hosts")[:, 0] != 0,
        p_static=geti("p_static"),
        p_dyn=geti("p_dyn")[:, 0],
    )


# ---------------------------------------------------------------------------
# Feasibility (plain version; every lane-dependent result is (B, N))
# ---------------------------------------------------------------------------


def _check_predicate(arrays: DeviceArrays, slot, op, want_hash, want_num):
    """(B, N) bool — one predicate per lane against every node.  ``slot``,
    ``op``, ``want_hash``, ``want_num`` are (B,).  Inactive predicates
    (slot < 0) pass.  Missing-attribute semantics follow checkConstraint
    (feasible.go:793-858): ``=`` and ordered comparisons require the
    attribute; ``!=`` passes when it is absent; NaN fails ordered
    comparisons."""
    safe = slot.clamp(min=0).long()
    h = arrays.attr_hash.index_select(1, safe).T  # (B, N)
    is_ver = (op >= OP_VER_EQ)[:, None]
    v = torch.where(
        is_ver,
        arrays.attr_ver.index_select(1, safe).T,
        arrays.attr_num.index_select(1, safe).T,
    )
    present = h != 0
    o = op[:, None]
    is_num = ((o >= OP_LT) & (o <= OP_GTE)) | is_ver
    is_pres = (o == OP_IS_SET) | (o == OP_IS_NOT_SET)
    negate = (o == OP_NEQ) | (o == OP_IS_NOT_SET)
    want_lt = (o == OP_LT) | (o == OP_LTE) | (o == OP_VER_LT) | (o == OP_VER_LTE)
    want_gt = (o == OP_GT) | (o == OP_GTE) | (o == OP_VER_GT) | (o == OP_VER_GTE)
    want_eq = (
        (o == OP_LTE) | (o == OP_GTE) | (o == OP_VER_EQ)
        | (o == OP_VER_LTE) | (o == OP_VER_GTE)
    )
    wn = want_num[:, None]
    cmp = (want_lt & (v < wn)) | (want_gt & (v > wn)) | (want_eq & (v == wn))
    inner = torch.where(is_num, cmp, is_pres | (h == want_hash[:, None]))
    res = (present & inner) ^ negate
    return res | (slot < 0)[:, None]


def constraint_mask(arrays: DeviceArrays, req: LaneRequest,
                    c_width: int = MAX_CONSTRAINTS):
    """(B, N) bool — every hard constraint passes."""
    b, n = req.c_slot.shape[0], arrays.attr_hash.shape[0]
    mask = torch.ones((b, n), dtype=torch.bool, device=arrays.used.device)
    for c in range(c_width):
        mask &= _check_predicate(
            arrays, req.c_slot[:, c], req.c_op[:, c], req.c_hash[:, c],
            req.c_num[:, c],
        )
    return mask


def datacenter_mask(arrays: DeviceArrays, req: LaneRequest):
    """(B, N) bool — the node's datacenter is in the job's list (attribute
    slot 0); ``dc_hash[0] == -1`` means the host filters instead."""
    dc = arrays.attr_hash[:, 0][None, :, None]  # (1, N, 1)
    want = req.dc_hash[:, None, :]  # (B, 1, DC)
    member = ((dc == want) & (want > 0)).any(dim=2)
    return member | (req.dc_hash[:, 0] == -1)[:, None]


def device_mask(arrays: DeviceArrays, req: LaneRequest):
    """(B, N) bool — free device instances cover the ask."""
    free = (arrays.dev_total - arrays.dev_used)[None]  # (1, N, D)
    ask = req.dev_ask[:, None, :]
    return ((free >= ask) | (ask == 0)).all(dim=2)


def port_mask(arrays: DeviceArrays, req: LaneRequest, enabled: bool = True):
    """(B, N) bool — no requested static port is taken in the node's
    bitmap, and the dynamic range has room.  ``port_words`` is the int32
    view of the u32 bitmap: ``(w >> bit) & 1`` reads the same bit."""
    b, n = req.p_static.shape[0], arrays.port_words.shape[0]
    if not enabled:
        return torch.ones((b, n), dtype=torch.bool, device=arrays.used.device)
    conflict = torch.zeros((b, n), dtype=torch.bool, device=arrays.used.device)
    for k in range(req.p_static.shape[1]):
        p = req.p_static[:, k]
        safe = p.clamp(min=0)
        words = arrays.port_words.index_select(1, (safe >> 5).long()).T
        taken = ((words >> (safe & 31)[:, None]) & 1) == 1
        conflict |= (p >= 0)[:, None] & taken
    dyn_ok = (arrays.dyn_used[None, :] + req.p_dyn[:, None]) <= DYN_PORT_CAPACITY
    return ~conflict & dyn_ok


def feasibility_mask(arrays: DeviceArrays, req: LaneRequest, class_elig,
                     host_mask, features: Features = FULL_FEATURES):
    """(B, N) bool — eligible ∧ dc ∧ constraints ∧ devices ∧ ports ∧
    class eligibility ∧ host mask."""
    mask = arrays.eligible[None, :] & datacenter_mask(arrays, req)
    mask = mask & constraint_mask(arrays, req, features.c_width)
    mask = mask & device_mask(arrays, req)
    mask = mask & port_mask(arrays, req, features.ports)
    # Gathers clamp out-of-range ids, as JAX's do.
    cid = arrays.class_id.clamp(min=0, max=class_elig.shape[1] - 1).long()
    by_class = class_elig.index_select(1, cid)  # (B, N)
    mask = mask & torch.where(arrays.class_id[None, :] < 0, False, by_class)
    return mask & host_mask


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


def fit_and_binpack(arrays: DeviceArrays, used, req: LaneRequest):
    """Resource fit + normalized fit score.  ``used`` is (B, N, 3).
    Returns (fits (B, N) bool, score (B, N) f32)."""
    util = used + req.ask[:, None, :]
    fits = (util <= arrays.totals[None]).all(dim=2)
    denom = arrays.totals.clamp(min=1.0)[None]
    free = 1.0 - util / denom
    log2_10 = torch.tensor(LOG2_10, dtype=torch.float32)
    total = torch.exp2(free[..., 0] * log2_10) + torch.exp2(free[..., 1] * log2_10)
    binpack = (20.0 - total).clamp(0.0, 18.0)
    spread = (total - 2.0).clamp(0.0, 18.0)
    score = torch.where((req.algorithm == 1)[:, None], spread, binpack) * INV_18
    return fits, score


def anti_affinity_score(tg_count, req: LaneRequest):
    """(score, appended) — JobAntiAffinityIterator (rank.go:560-607)."""
    collisions = tg_count.to(torch.float32)
    score = -(collisions + 1.0) / req.desired_count[:, None]
    appended = collisions > 0
    return torch.where(appended, score, 0.0), appended


def penalty_score(penalty_mask):
    """NodeReschedulingPenaltyIterator (rank.go:630-646)."""
    return torch.where(penalty_mask, -1.0, 0.0), penalty_mask


def affinity_score(arrays: DeviceArrays, req: LaneRequest,
                   a_width: int = MAX_AFFINITIES):
    """NodeAffinityIterator (rank.go:698-728): Σ weight·match / Σ|weight|,
    appended only when non-zero."""
    b, n = req.a_slot.shape[0], arrays.attr_hash.shape[0]
    dev = arrays.used.device
    total = torch.zeros((b, n), dtype=torch.float32, device=dev)
    sum_weight = torch.zeros((b,), dtype=torch.float32, device=dev)
    if a_width == 0:
        return total, torch.zeros((b, n), dtype=torch.bool, device=dev)
    for a in range(a_width):
        active = req.a_slot[:, a] >= 0
        w = req.a_weight[:, a]
        match = _check_predicate(
            arrays, req.a_slot[:, a], req.a_op[:, a], req.a_hash[:, a],
            req.a_num[:, a],
        ) & active[:, None]
        total = total + match.to(torch.float32) * w[:, None]
        sum_weight = sum_weight + w.abs() * active.to(torch.float32)
    norm = total / sum_weight.clamp(min=1e-9)[:, None]
    appended = (total != 0.0) & (sum_weight > 0)[:, None]
    return torch.where(appended, norm, 0.0), appended


def spread_score(arrays: DeviceArrays, req: LaneRequest, s_value_hash,
                 spread_counts, s_width: int = MAX_SPREADS):
    """SpreadIterator (spread.go:110-257).  ``s_value_hash`` (B, S, V) is
    the carried known-values table, ``spread_counts`` (B, S, V) the usage
    count per value.  Returns (score, appended), each (B, N)."""
    b, n = req.s_slot.shape[0], arrays.attr_hash.shape[0]
    dev = arrays.used.device
    total = torch.zeros((b, n), dtype=torch.float32, device=dev)
    if s_width == 0:
        return total, torch.zeros((b, n), dtype=torch.bool, device=dev)
    for s in range(s_width):
        slot = req.s_slot[:, s]
        active = (slot >= 0)[:, None]
        nvalue = arrays.attr_hash.index_select(1, slot.clamp(min=0).long()).T
        node_has = nvalue != 0
        vh = s_value_hash[:, s, :]  # (B, V)
        counts = spread_counts[:, s, :]
        desired = req.s_desired[:, s, :]
        vmatch = (nvalue[:, :, None] == vh[:, None, :]) & (vh[:, None, :] != 0)
        count_at = torch.where(vmatch, counts[:, None, :], 0.0).sum(dim=2)
        used_count = count_at + 1.0

        # targeted mode (spread.go:134-165)
        desired_ok = ~torch.isnan(desired)[:, None, :]
        has_target = (vmatch & desired_ok).any(dim=2)
        desired_at = torch.where(
            vmatch & desired_ok, desired[:, None, :], 0.0
        ).sum(dim=2)
        desired_v = torch.where(has_target, desired_at, float("nan"))
        implicit = req.s_implicit[:, s][:, None]
        use_implicit = ~has_target & ~torch.isnan(implicit)
        desired_v = torch.where(use_implicit, implicit, desired_v)
        no_target = torch.isnan(desired_v)
        rel_weight = req.s_weight[:, s] / req.s_sum_weights.clamp(min=1e-9)
        boost_t = (
            (desired_v - used_count) / desired_v.clamp(min=1e-9)
        ) * rel_weight[:, None]
        targeted = torch.where(no_target, -1.0, boost_t)

        # even mode (spread.go evenSpreadScoreBoost:178-230)
        valid = (vh != 0) & (counts > 0)
        any_use = valid.any(dim=1)[:, None]
        mn = torch.where(valid, counts, 1e30).amin(dim=1)[:, None]
        mx = torch.where(valid, counts, -1e30).amax(dim=1)[:, None]
        current = count_at
        delta_boost = torch.where(
            mn == 0, -1.0, (mn - current) / mn.clamp(min=1e-9)
        )
        at_min = torch.where(
            mn == mx, -1.0,
            torch.where(mn == 0, 1.0, (mx - mn) / mn.clamp(min=1e-9)),
        )
        even_b = torch.where(current != mn, delta_boost, at_min)
        even_b = torch.where(any_use, even_b, 0.0)
        even_b = torch.where(node_has, even_b, -1.0)

        score = torch.where(req.s_even[:, s][:, None], even_b, targeted)
        total = total + torch.where(active, score, 0.0)
    has_spread = (req.s_slot[:, :s_width] >= 0).any(dim=1)[:, None]
    appended = (total != 0.0) & has_spread
    return torch.where(appended, total, 0.0), appended


def preemption_state(arrays: DeviceArrays, req: LaneRequest):
    """Vectorized preemption candidate math: everything strictly below the
    lane's ``preempt_bucket`` is evictable.  Prefix sums over the bucket
    axis are computed once and each lane reads its bucket's row.
    Returns (extra_free (B, N, 3), score (B, N), usable (B, N) bool)."""
    pu = arrays.prio_used  # (N, P, 3)
    n = pu.shape[0]
    dev = pu.device
    zero3 = torch.zeros((1, n, 3), dtype=torch.float32, device=dev)
    csum = torch.cat([zero3, pu.permute(1, 0, 2).cumsum(dim=0)], dim=0)
    mid = (torch.arange(PRIORITY_BUCKETS, dtype=torch.float32, device=dev)
           + 0.5) * (101.0 / PRIORITY_BUCKETS)
    present = (pu > 0).any(dim=2).T  # (P, N)
    mid_masked = torch.where(present, mid[:, None], 0.0)
    zero1 = torch.zeros((1, n), dtype=torch.float32, device=dev)
    mid_max = torch.cat([zero1, mid_masked.cummax(dim=0).values], dim=0)
    mid_sum = torch.cat([zero1, mid_masked.cumsum(dim=0)], dim=0)

    k = req.preempt_bucket.clamp(0, PRIORITY_BUCKETS).long()
    freeable = csum[k]  # (B, N, 3)
    max_prio = mid_max[k]
    sum_prio = mid_sum[k]
    net = torch.where(
        max_prio > 0, max_prio + sum_prio / max_prio.clamp(min=1e-9), 0.0
    )
    score = 1.0 / (1.0 + torch.exp(PREEMPTION_RATE * (net - PREEMPTION_ORIGIN)))
    usable = (req.preempt_bucket >= 0)[:, None] & (freeable > 0).any(dim=2)
    return freeable, score, usable


class ScoreResult(NamedTuple):
    final: torch.Tensor  # (B, N) f32, NEG_INF where infeasible
    feasible: torch.Tensor  # (B, N) bool
    fits: torch.Tensor  # (B, N) bool (incl. preemption assist)
    needs_preempt: torch.Tensor  # (B, N) bool
    binpack: torch.Tensor  # (B, N) f32


class _StaticParts(NamedTuple):
    """Per-lane terms that do not change across placement steps."""

    feas: torch.Tensor
    pen_score: torch.Tensor
    pen_app: torch.Tensor
    aff_score: torch.Tensor
    aff_app: torch.Tensor
    extra_free: Optional[torch.Tensor]
    pre_score: Optional[torch.Tensor]
    pre_usable: Optional[torch.Tensor]


def _static_parts(arrays, req, penalty, class_elig, host_mask,
                  features: Features) -> _StaticParts:
    feas = feasibility_mask(arrays, req, class_elig, host_mask, features)
    pen_score, pen_app = penalty_score(penalty)
    aff_score, aff_app = affinity_score(arrays, req, features.a_width)
    if features.preempt:
        extra_free, pre_score, pre_usable = preemption_state(arrays, req)
    else:
        extra_free = pre_score = pre_usable = None
    return _StaticParts(feas, pen_score, pen_app, aff_score, aff_app,
                        extra_free, pre_score, pre_usable)


def _score_step(arrays, req, sp: _StaticParts, used, tg_count, s_value_hash,
                spread_counts, features: Features) -> ScoreResult:
    feas = sp.feas & ~(req.distinct_hosts[:, None] & (tg_count > 0))
    fits, binpack = fit_and_binpack(arrays, used, req)
    if features.preempt:
        util = used + req.ask[:, None, :]
        fits_with_preempt = (util - sp.extra_free <= arrays.totals[None]).all(dim=2)
        needs_preempt = ~fits & fits_with_preempt & sp.pre_usable
        fits_all = fits | needs_preempt
        pre_component = torch.where(needs_preempt, sp.pre_score, 0.0)
    else:
        needs_preempt = torch.zeros_like(fits)
        fits_all = fits
        pre_component = torch.zeros_like(binpack)
    aa_score, aa_app = anti_affinity_score(tg_count, req)
    spr_score, spr_app = spread_score(
        arrays, req, s_value_hash, spread_counts, features.s_width
    )
    total = binpack + aa_score + sp.pen_score + sp.aff_score + spr_score + pre_component
    f32 = torch.float32
    count = (
        1.0
        + aa_app.to(f32)
        + sp.pen_app.to(f32)
        + sp.aff_app.to(f32)
        + spr_app.to(f32)
        + needs_preempt.to(f32)
    )
    final = torch.where(feas & fits_all, total / count, NEG_INF)
    return ScoreResult(final, feas, fits_all, needs_preempt, binpack)


def score_nodes(arrays: DeviceArrays, used, tg_count, spread_counts,
                penalty, req_i, req_f, class_elig, host_mask,
                features: Features = FULL_FEATURES) -> ScoreResult:
    """The full ranking pipeline for B lanes (GenericStack.Select,
    stack.go:117-179): ``used`` (B, N, 3), ``tg_count``/``penalty``/
    ``host_mask`` (B, N), ``spread_counts`` (B, S, V), ``class_elig``
    (B, K), packed requests ``req_i``/``req_f``."""
    req = unpack_requests(req_i, req_f)
    sp = _static_parts(arrays, req, penalty, class_elig, host_mask, features)
    return _score_step(arrays, req, sp, used, tg_count, req.s_value_hash,
                       spread_counts, features)


def _apply_spread_values(req: LaneRequest, lane: int, s_hash, s_counts,
                         nvalues) -> None:
    """In place, for one lane: bump the placed node's value count per
    stanza, claiming an empty value slot on first sight of a new value
    (kernels.apply_spread_values)."""
    for s in range(MAX_SPREADS):
        slot = int(req.s_slot[lane, s])
        nv = int(nvalues[s])
        vh = s_hash[lane, s]
        match = (vh == nv) & (nv != 0)
        have = bool(match.any())
        zeros = vh == 0
        free_slot = int(torch.argmax(zeros.to(torch.int32))) if bool(zeros.any()) else 0
        idx = int(torch.argmax(match.to(torch.int32))) if have else free_slot
        can = slot >= 0 and nv != 0 and (have or int(vh[free_slot]) == 0)
        if can and not have:
            vh[idx] = nv
        if can:
            s_counts[lane, s, idx] += 1.0


# ---------------------------------------------------------------------------
# The placement scan (plain version of the fused_place kernel)
# ---------------------------------------------------------------------------

# Columns of the packed per-lane output (one fetch per dispatch).
PACKED_ROW = 0
PACKED_SCORE = 1
PACKED_BINPACK = 2
PACKED_PREEMPT = 3
PACKED_EVALUATED = 4
PACKED_FILTERED = 5
PACKED_EXHAUSTED = 6
PACKED_WIDTH = 7
# The fused output's VERIFIED column: 1.0 the placement survives the
# sequential cross-lane AllocsFit re-check, 0.0 an earlier lane claimed
# the capacity first, -1.0 dead lane.
FUSED_PACKED_VERIFIED = 7
FUSED_PACKED_WIDTH = 8
# In-flight delta rows a lane of fused_place / place_batch may carry
# (csrc/fused_place.cu keeps them in shared memory; the coalescer sends 32).
MAX_LANE_DELTAS = 1024


def _pick(res: ScoreResult, eligible, live=None):
    """Each lane's pick from its scores (the reference's
    ``_score_and_pick``): the first maximum of ``final`` (lowest row on
    ties, as ``jnp.argmax``), and the packed (B, PACKED_WIDTH) row: row -1
    and zero score, binpack and preemption where nothing fits, the three
    node counters over every row.  Lanes outside ``live`` read row -1 and
    zeros.  Returns (packed, row, ok)."""
    f32 = torch.float32
    row = torch.argmax(res.final, dim=1)
    best = res.final.gather(1, row[:, None])[:, 0]
    ok = best > NEG_INF / 2
    if live is not None:
        ok = ok & live
    counts = torch.stack([
        res.feasible.sum(dim=1),
        (~res.feasible & eligible[None]).sum(dim=1),
        (res.feasible & ~res.fits).sum(dim=1),
    ], dim=1).to(f32)
    if live is not None:
        counts = torch.where(live[:, None], counts, 0.0)
    packed = torch.cat([
        torch.stack([
            torch.where(ok, row.to(f32), -1.0),
            torch.where(ok, best, 0.0),
            torch.where(ok, res.binpack.gather(1, row[:, None])[:, 0], 0.0),
            (ok & res.needs_preempt.gather(1, row[:, None])[:, 0]).to(f32),
        ], dim=1),
        counts,
    ], dim=1)
    return packed, row, ok


def lane_base_usage(used, delta_rows, delta_vals, row_offset: int = 0):
    """(B, N, 3) — each lane's base usage: ``used`` plus its ≤ D sparse
    in-flight deltas (row -1 = padding).  Duplicate rows sum, in delta
    order, as ``.at[].add`` does.  ``used`` may be one node shard's rows
    from global row ``row_offset`` on (the deltas' rows stay global)."""
    base = used[None].repeat(delta_rows.shape[0], 1, 1)
    _add_deltas_in_order(base, delta_rows, delta_vals, row_offset=row_offset)
    return base


def _add_deltas_in_order(target, delta_rows, delta_vals, lane=None,
                         row_offset: int = 0) -> None:
    """Add each live delta row into ``target`` ((B, N, 3), or (N, 3) for
    one ``lane``) one at a time, in delta order — a fixed summation order
    where ``index_add_`` on the card would use atomics.  ``target`` holds
    the global rows ``[row_offset, row_offset + N)``; deltas outside them
    are skipped."""
    n = target.shape[-2]
    lanes = range(delta_rows.shape[0]) if lane is None else [lane]
    for ln in lanes:
        for j in torch.nonzero(delta_rows[ln] >= 0).flatten().tolist():
            r = int(delta_rows[ln, j]) - row_offset
            if 0 <= r < n:
                dst = target[ln] if lane is None else target
                dst[r] += delta_vals[ln, j]


def place_lanes(arrays: DeviceArrays, used, delta_rows, delta_vals,
                tg_counts, spread_counts, penalties, req_i, req_f,
                class_eligs, host_masks, lane_mask, n_placements: int,
                features: Features = FULL_FEATURES):
    """Plain version of the ``fused_place`` kernel: B placement scans of
    ``n_placements`` steps.  Returns (B, P, PACKED_WIDTH) f32; dead lanes
    (``lane_mask`` False) read row -1 and zeros.

    Lanes never read each other's state, so only the live lanes are
    scanned: their rows of the request, the operands and the carries are
    gathered, scored and scattered back into the output, which gives every
    live lane the same bits as a scan of all B lanes.  Rows past the last
    eligible one are never feasible: they score ``NEG_INF`` and count in
    no counter, so the scan leaves them out too (every pick is the same
    first maximum, every count the same)."""
    place_lanes.calls += 1
    b = req_i.shape[0]
    dev = used.device
    out = torch.zeros((b, n_placements, PACKED_WIDTH), dtype=torch.float32,
                      device=dev)
    out[:, :, PACKED_ROW] = -1.0
    idx = torch.nonzero(lane_mask).flatten()
    if idx.numel() == 0:
        return out
    eligible_rows = torch.nonzero(arrays.eligible).flatten()
    n_rows = int(eligible_rows[-1]) + 1 if eligible_rows.numel() else 1
    if n_rows < used.shape[0]:
        arrays = DeviceArrays(*(col[:n_rows] for col in arrays))
        used = used[:n_rows]
        tg_counts, penalties, host_masks = (
            x[:, :n_rows] for x in (tg_counts, penalties, host_masks))
    if idx.numel() < b:
        delta_rows, delta_vals, tg_counts, spread_counts, penalties = (
            x.index_select(0, idx) for x in (
                delta_rows, delta_vals, tg_counts, spread_counts, penalties))
        req_i, req_f, class_eligs, host_masks = (
            x.index_select(0, idx) for x in (
                req_i, req_f, class_eligs, host_masks))
    req = unpack_requests(req_i, req_f)
    u = lane_base_usage(used, delta_rows, delta_vals)
    tg = tg_counts.to(torch.int32).clone()
    s_hash = req.s_value_hash.clone()
    s_counts = spread_counts.to(torch.float32).clone()
    sp = _static_parts(arrays, req, penalties, class_eligs, host_masks, features)
    live_out = torch.empty((idx.numel(), n_placements, PACKED_WIDTH),
                           dtype=torch.float32, device=dev)
    for step in range(n_placements):
        res = _score_step(arrays, req, sp, u, tg, s_hash, s_counts, features)
        live_out[:, step], row, ok = _pick(res, arrays.eligible)
        # Carry update on the winning row of each placing lane.
        for lane in torch.nonzero(ok).flatten().tolist():
            r = int(row[lane])
            u[lane, r] += req.ask[lane]
            tg[lane, r] += 1
            if features.s_width:
                nvalues = arrays.attr_hash[r, req.s_slot[lane].clamp(min=0).long()]
                _apply_spread_values(req, lane, s_hash, s_counts, nvalues)
    out.index_copy_(0, idx, live_out)
    return out


place_lanes.calls = 0


def verify_lanes(totals, used, packed, req_f, delta_rows, delta_vals,
                 lane_mask, row_offset: int = 0, and_with=None):
    """Plain version of the ``allocs_fit_verify`` kernel: the sequential
    cross-lane AllocsFit scan plus the dead-lane pack.

    Lanes are taken in order; each live lane adds its in-flight deltas to
    a cumulative usage, then commits its placements one by one and checks
    ``u[row] <= totals[row]`` on all three dimensions.  Returns the
    (B, P, FUSED_PACKED_WIDTH) output: columns 0-6 from ``packed`` (dead
    lanes row -1, zeros), column 7 the verdict (-1.0 on dead lanes, 1.0 on
    a pick with no row in the window).

    The window: ``totals``/``used`` hold the global rows ``[row_offset,
    row_offset + N)`` (one node shard's; rows in ``packed`` and the deltas
    stay global), and a pick outside them fits vacuously.  ``and_with``
    ((S', B, P) float32, the other shards' verdict columns) is folded in
    last, each pick's least verdict: the cross-shard AND."""
    verify_lanes.calls += 1
    b, p, n = packed.shape[0], packed.shape[1], used.shape[0]
    ask = req_f[:, REQ_FLOAT_OFF["ask"][0]:REQ_FLOAT_OFF["ask"][0] + 3]
    out = torch.zeros((b, p, FUSED_PACKED_WIDTH), dtype=torch.float32,
                      device=packed.device)
    out[:, :, :PACKED_WIDTH] = packed
    cum = used.clone()
    for lane in range(b):
        if not bool(lane_mask[lane]):
            out[lane] = 0.0
            out[lane, :, PACKED_ROW] = -1.0
            out[lane, :, FUSED_PACKED_VERIFIED] = -1.0
            continue
        _add_deltas_in_order(cum, delta_rows, delta_vals, lane=lane,
                             row_offset=row_offset)
        for step in range(p):
            r = int(packed[lane, step, PACKED_ROW]) - row_offset
            if r < 0 or r >= n:
                out[lane, step, FUSED_PACKED_VERIFIED] = 1.0
                continue
            cum[r] += ask[lane]
            out[lane, step, FUSED_PACKED_VERIFIED] = float(
                bool((cum[r] <= totals[r]).all())
            )
    if and_with is not None:
        for cols in and_with:
            out[:, :, FUSED_PACKED_VERIFIED] = torch.minimum(
                out[:, :, FUSED_PACKED_VERIFIED], cols)
    return out


verify_lanes.calls = 0


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


# Library entry points by name, resolved once: ``load_library`` builds
# and loads every kernel on its first call.
_entries: dict = {}


def _entry(lib: str, name: str):
    """The ``ctypes`` function ``name`` of kernel library ``lib``."""
    fn = _entries.get(name)
    if fn is None:
        from .build import load_library

        fn = _entries[name] = getattr(load_library(lib), name)
    return fn


class _ColumnMemo:
    """Sets of columns that passed a wrapper's checks, each with its
    device, rows and the columns' pointers as a ctypes array, the newest
    first (at most ``_MEMO_ENTRIES``): the dispatch loops pass the same
    immutable columns again and again (one set per node shard on the
    sharded path), so their checks run once per set.  Weak references let
    replaced columns be freed (a dead one matches no tensor); the tuple is
    replaced whole, so threads see whole entries."""

    def __init__(self):
        self.entries: tuple = ()

    def get(self, cols, device):
        """(rows, pointers) of ``cols`` on ``device`` if checked, else None."""
        for memo in self.entries:
            if (memo[1] == device and len(memo[0]) == len(cols)
                    and all(r() is t for r, t in zip(memo[0], cols))):
                return memo[2], memo[3]
        return None

    def put(self, cols, device, n: int):
        """Remember ``cols`` as checked; returns (rows, pointers)."""
        ptrs = (ctypes.c_void_p * len(cols))(*[t.data_ptr() for t in cols])
        entry = (tuple(weakref.ref(t) for t in cols), device, n, ptrs)
        live = tuple(m for m in self.entries if m[0] and m[0][0]() is not None)
        self.entries = (entry,) + live[:_MEMO_ENTRIES - 1]
        return n, ptrs


_MEMO_ENTRIES = 32
_checked_matrices = _ColumnMemo()


def _check_matrix(arrays: DeviceArrays, used, device) -> int:
    return _checked_cols(arrays, used, device)[0]


def _checked_cols(arrays: DeviceArrays, used, device):
    """(rows, the columns' device pointers as a ctypes array in
    DeviceArrays order) of a matrix whose columns and ``used`` pass the
    checks; raises otherwise."""
    n = arrays.totals.shape[0]
    _check("used", used, torch.float32, (n, 3), device)
    got = _checked_matrices.get(arrays, device)
    if got is not None:
        return got
    a = arrays.attr_hash.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check("totals", arrays.totals, f32, (n, 3), device)
    _check("eligible", arrays.eligible, torch.bool, (n,), device)
    _check("attr_hash", arrays.attr_hash, i32, (n, a), device)
    _check("attr_num", arrays.attr_num, f32, (n, a), device)
    _check("attr_ver", arrays.attr_ver, f32, (n, a), device)
    _check("class_id", arrays.class_id, i32, (n,), device)
    _check("dev_total", arrays.dev_total, i32, (n, DEVICE_SLOTS), device)
    _check("dev_used", arrays.dev_used, i32, (n, DEVICE_SLOTS), device)
    _check("prio_used", arrays.prio_used, f32, (n, PRIORITY_BUCKETS, 3), device)
    _check("port_words", arrays.port_words, i32,
           (n, arrays.port_words.shape[1]), device)
    _check("dyn_used", arrays.dyn_used, i32, (n,), device)
    return _checked_matrices.put(arrays, device, n)


def _matrix_ptrs(arrays: DeviceArrays, used):
    """The matrix columns' device pointers in the kernels' argument order."""
    return (arrays.totals.data_ptr(), used.data_ptr(),
            arrays.eligible.data_ptr(), arrays.attr_hash.data_ptr(),
            arrays.attr_num.data_ptr(), arrays.attr_ver.data_ptr(),
            arrays.class_id.data_ptr(), arrays.dev_total.data_ptr(),
            arrays.dev_used.data_ptr(), arrays.prio_used.data_ptr(),
            arrays.port_words.data_ptr(), arrays.dyn_used.data_ptr())


# The current stream's raw handle without building a Stream object (the
# accessor PyTorch's own generated code uses); absent from CPU-only builds.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


# The current card's index without a Python device object; absent from
# CPU-only builds.
_current_index = getattr(torch._C, "_cuda_getDevice", None)
_SAME_CARD = contextlib.nullcontext()


def _on(device):
    """``device``'s card made current for a launch: the ``ctypes``
    launches run on the current device, and a kernel's one-time
    attributes are set per device.  No switch when it is current already
    (the one-card path)."""
    if _current_index is not None and _current_index() == device.index:
        return _SAME_CARD
    return torch.cuda.device(device)


_shapes: dict = {}


def fused_place_shape(n: int, b: int, d: int, n_placements: int,
                      features: Features) -> dict:
    """The launch shape ``csrc/fused_place.cu`` takes for these sizes:
    ``cluster`` (CTAs a lane runs on), ``span`` (node rows a CTA owns),
    ``smem`` (dynamic shared memory bytes), ``state_in_smem`` (the
    candidate state fits shared memory; else ``scratch_cta`` bytes of
    device scratch per CTA) and ``tier`` (the loop-width instantiation:
    0 bench, 1 full).  Needs the built library (the card)."""
    key = ("fused_place", n, b, d, n_placements, features)
    got = _shapes.get(key)
    if got is None:
        buf = (ctypes.c_longlong * 6)()
        _entry("fused_place", "nomad_fused_place_shape")(
            n, b, d, n_placements, features.c_width, features.a_width,
            features.s_width, int(features.preempt), int(features.ports), buf)
        got = dict(cluster=buf[0], span=buf[1], smem=buf[2],
                   state_in_smem=bool(buf[3]), scratch_cta=buf[4],
                   tier=buf[5])
        _shapes[key] = got
    return got


def score_batch_shape(n: int, b: int, features: Features) -> dict:
    """The launch shape ``csrc/score_batch.cu`` takes for these sizes:
    ``cluster`` (CTAs that split a lane tile's node axis), ``lanes``
    (lanes per CTA), ``node_tile`` (rows staged per tile), ``smem``
    (dynamic shared memory bytes) and ``tier`` (the loop-width
    instantiation: 0 bench, 1 full).  Needs the built library (the card)."""
    key = ("score_batch", n, b, features)
    got = _shapes.get(key)
    if got is None:
        buf = (ctypes.c_int * 5)()
        _entry("score_batch", "nomad_score_batch_shape")(
            n, b, features.c_width, features.a_width, features.s_width,
            int(features.preempt), int(features.ports), buf)
        got = dict(cluster=buf[0], lanes=buf[1], node_tile=buf[2],
                   smem=buf[3], tier=buf[4])
        _shapes[key] = got
    return got


def _launch_fused_place(name: str, arrays: DeviceArrays, used, delta_rows,
                        delta_vals, tg_counts, spread_counts, penalties,
                        req_i, req_f, class_eligs, host_masks, lane_mask,
                        n_placements: int, features: Features):
    """Check the operands and launch ``csrc/fused_place.cu`` on the card;
    ``name`` is the wrapper whose launch this is (error messages)."""
    if used.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {used.device}")
    dev = used.device
    n = _check_matrix(arrays, used, dev)
    b, d = delta_rows.shape
    k = class_eligs.shape[1]
    _check("delta_rows", delta_rows, torch.int32, (b, d), dev)
    _check("delta_vals", delta_vals, torch.float32, (b, d, 3), dev)
    _check("tg_counts", tg_counts, torch.int32, (b, n), dev)
    _check("spread_counts", spread_counts, torch.float32,
           (b, MAX_SPREADS, MAX_SPREAD_VALUES), dev)
    _check("penalties", penalties, torch.bool, (b, n), dev)
    _check("req_i", req_i, torch.int32, (b, REQ_INT_WIDTH), dev)
    _check("req_f", req_f, torch.float32, (b, REQ_FLOAT_WIDTH), dev)
    _check("class_eligs", class_eligs, torch.bool, (b, k), dev)
    _check("host_masks", host_masks, torch.bool, (b, n), dev)
    _check("lane_mask", lane_mask, torch.bool, (b,), dev)
    if n_placements < 1:
        raise ValueError("n_placements must be >= 1")
    launch = _entry("fused_place", "nomad_fused_place")
    out = torch.empty((b, n_placements, PACKED_WIDTH), dtype=torch.float32,
                      device=dev)
    with _on(dev):
        shape = fused_place_shape(n, b, d, n_placements, features)
        # Candidate state that does not fit a CTA's shared memory lives in
        # a per-CTA device scratch (large N); none at the main path's
        # sizes.
        scratch = None
        if not shape["state_in_smem"]:
            scratch = torch.empty(
                (b * shape["cluster"] * shape["scratch_cta"],),
                dtype=torch.uint8, device=dev)
        rc = launch(
            *_matrix_ptrs(arrays, used),
            delta_rows.data_ptr(), delta_vals.data_ptr(),
            tg_counts.data_ptr(), spread_counts.data_ptr(),
            penalties.data_ptr(), req_i.data_ptr(), req_f.data_ptr(),
            class_eligs.data_ptr(), host_masks.data_ptr(),
            lane_mask.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            n, arrays.attr_hash.shape[1], arrays.port_words.shape[1], b, d,
            k, n_placements, features.c_width, features.a_width,
            features.s_width, int(features.preempt), int(features.ports),
            _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def _check_delta_width(name: str, delta_rows) -> None:
    """Both devices refuse more delta rows a lane than the card's kernel
    holds, so a batch the CPU takes also launches on the card."""
    if delta_rows.shape[-1] > MAX_LANE_DELTAS:
        raise ValueError(f"{name}: {delta_rows.shape[-1]} delta rows a lane, "
                         f"at most {MAX_LANE_DELTAS}")


def fused_place(arrays: DeviceArrays, used, delta_rows, delta_vals,
                tg_counts, spread_counts, penalties, req_i, req_f,
                class_eligs, host_masks, lane_mask, n_placements: int,
                features: Features = FULL_FEATURES):
    """B placement scans in one launch — the ``fused_place`` kernel
    (``csrc/fused_place.cu``) on the card, :func:`place_lanes` on the CPU.
    A lane carries at most ``MAX_LANE_DELTAS`` delta rows.  Returns (B,
    n_placements, PACKED_WIDTH) f32."""
    _check_delta_width("fused_place", delta_rows)
    if used.device.type == "cpu":
        return place_lanes(arrays, used, delta_rows, delta_vals, tg_counts,
                           spread_counts, penalties, req_i, req_f,
                           class_eligs, host_masks, lane_mask, n_placements,
                           features)
    out = _launch_fused_place(
        "fused_place", arrays, used, delta_rows, delta_vals, tg_counts,
        spread_counts, penalties, req_i, req_f, class_eligs, host_masks,
        lane_mask, n_placements, features)
    fused_place.launches += 1
    return out


fused_place.launches = 0


def place_batch_plain(arrays: DeviceArrays, used, delta_rows, delta_vals,
                      tg_counts, spread_counts, penalties, req_i, req_f,
                      class_eligs, host_masks, n_placements: int,
                      features: Features = FULL_FEATURES):
    """Plain version of ``place_batch``: :func:`place_lanes` with every
    lane live.  Returns (B, n_placements, PACKED_WIDTH) f32."""
    live = torch.ones((req_i.shape[0],), dtype=torch.bool, device=used.device)
    return place_lanes(arrays, used, delta_rows, delta_vals, tg_counts,
                       spread_counts, penalties, req_i, req_f, class_eligs,
                       host_masks, live, n_placements, features)


def place_batch(arrays: DeviceArrays, used, delta_rows, delta_vals,
                tg_counts, spread_counts, penalties, req_i, req_f,
                class_eligs, host_masks, n_placements: int,
                features: Features = FULL_FEATURES):
    """B independent placement scans in one launch, with no lane mask and
    no verify column — the staged dispatch (JAX ``_place_batch_impl``,
    ``nomad_tpu/ops/kernels.py:817``).  Its body is the per-lane scan of
    the fused dispatch, so on the card this launches
    ``csrc/fused_place.cu`` with every lane live; on the CPU it runs
    :func:`place_batch_plain`.  A lane whose host mask is all False (the
    reference's padding) places nothing and counts every eligible node as
    filtered, as the reference's does.  A lane carries at most
    ``MAX_LANE_DELTAS`` delta rows.  Returns (B, n_placements,
    PACKED_WIDTH) f32."""
    _check_delta_width("place_batch", delta_rows)
    if used.device.type == "cpu":
        return place_batch_plain(arrays, used, delta_rows, delta_vals,
                                 tg_counts, spread_counts, penalties, req_i,
                                 req_f, class_eligs, host_masks,
                                 n_placements, features)
    live = torch.ones((req_i.shape[0],), dtype=torch.bool, device=used.device)
    out = _launch_fused_place(
        "place_batch", arrays, used, delta_rows, delta_vals, tg_counts,
        spread_counts, penalties, req_i, req_f, class_eligs, host_masks,
        live, n_placements, features)
    place_batch.launches += 1
    return out


place_batch.launches = 0


def allocs_fit_verify_shape(n: int, b: int, p: int, d: int) -> dict:
    """The launch plan ``csrc/allocs_fit_verify.cu`` takes for these
    sizes: ``tier`` (0: its event arrays in shared memory, 1: in device
    scratch), ``passes`` and ``digit_bits`` of its radix sort by row,
    ``events`` (B·(D + P) candidates), ``smem`` (dynamic shared memory
    bytes) and ``scratch`` (device scratch bytes, tier 1).  Needs the
    built library (the card)."""
    key = ("allocs_fit_verify", n, b, p, d)
    got = _shapes.get(key)
    if got is None:
        buf = (ctypes.c_longlong * 6)()
        _entry("allocs_fit_verify", "nomad_allocs_fit_verify_shape")(
            n, b, p, d, buf)
        got = dict(tier=buf[0], passes=buf[1], digit_bits=buf[2],
                   events=buf[3], smem=buf[4], scratch=buf[5])
        _shapes[key] = got
    return got


def allocs_fit_verify(totals, used, packed, req_f, delta_rows, delta_vals,
                      lane_mask, row_offset: Optional[int] = None,
                      and_with=None):
    """The sequential cross-lane AllocsFit scan and the dead-lane pack —
    the ``allocs_fit_verify`` kernel (``csrc/allocs_fit_verify.cu``, a
    row-segmented scan) on the card, :func:`verify_lanes` on the CPU.
    Returns (B, P, FUSED_PACKED_WIDTH) f32.

    With ``row_offset`` the launch is the windowed one of the node-sharded
    verify: ``totals``/``used`` are one shard's rows from global row
    ``row_offset`` on, picks outside them fit vacuously, and ``and_with``
    ((S', B, P) f32, or None) holds the other shards' verdict columns,
    which the kernel folds in last (their least verdict).  Those launches
    count in ``allocs_fit_verify.window_launches``, the unsharded ones in
    ``allocs_fit_verify.launches``."""
    dev = used.device
    windowed = row_offset is not None
    if dev.type == "cpu":
        return verify_lanes(totals, used, packed, req_f, delta_rows,
                            delta_vals, lane_mask, row_offset or 0, and_with)
    if dev.type != "cuda":
        raise ValueError(f"allocs_fit_verify: unsupported device {dev}")
    n = totals.shape[0]
    b, p = packed.shape[0], packed.shape[1]
    d = delta_rows.shape[1]
    _check("totals", totals, torch.float32, (n, 3), dev)
    _check("used", used, torch.float32, (n, 3), dev)
    _check("packed", packed, torch.float32, (b, p, PACKED_WIDTH), dev)
    _check("req_f", req_f, torch.float32, (b, REQ_FLOAT_WIDTH), dev)
    _check("delta_rows", delta_rows, torch.int32, (b, d), dev)
    _check("delta_vals", delta_vals, torch.float32, (b, d, 3), dev)
    _check("lane_mask", lane_mask, torch.bool, (b,), dev)
    n_and = 0
    if and_with is not None:
        n_and = and_with.shape[0]
        _check("and_with", and_with, torch.float32, (n_and, b, p), dev)
    if row_offset is not None and row_offset < 0:
        raise ValueError("row_offset must be >= 0")
    launch = _entry("allocs_fit_verify", "nomad_allocs_fit_verify")
    out = torch.empty((b, p, FUSED_PACKED_WIDTH), dtype=torch.float32,
                      device=dev)
    # Event arrays past the shared-memory tier live in a device scratch;
    # none at the main path's sizes.
    plan = allocs_fit_verify_shape(n, b, p, d)
    with _on(dev):
        scratch = None
        if plan["tier"]:
            scratch = torch.empty((plan["scratch"] // 4,), dtype=torch.int32,
                                  device=dev)
        rc = launch(
            totals.data_ptr(), used.data_ptr(), packed.data_ptr(),
            req_f.data_ptr(), delta_rows.data_ptr(), delta_vals.data_ptr(),
            lane_mask.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if and_with is None else and_with.data_ptr(), n, b, p, d,
            row_offset or 0, n_and, _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"allocs_fit_verify launch failed: CUDA error {rc}")
    if windowed:
        allocs_fit_verify.window_launches += 1
    else:
        allocs_fit_verify.launches += 1
    return out


allocs_fit_verify.launches = 0
allocs_fit_verify.window_launches = 0


def system_feasible_plain(arrays: DeviceArrays, used0, req_i, req_f,
                          class_elig, host_mask):
    """Plain version of the ``system_feasible`` kernel: the full-feature
    :func:`feasibility_mask` and the fit of :func:`fit_and_binpack` at
    B=1, stacked as ``[mask, fits]``, (2, N) bool."""
    system_feasible_plain.calls += 1
    req = unpack_requests(req_i, req_f)
    mask = feasibility_mask(arrays, req, class_elig[None], host_mask[None])
    fits, _ = fit_and_binpack(arrays, used0[None], req)
    return torch.stack([mask[0], fits[0]])


system_feasible_plain.calls = 0


def system_feasible(arrays: DeviceArrays, used0, req_i, req_f, class_elig,
                    host_mask):
    """Feasibility and fit of one request on every node — the
    ``system_feasible`` kernel (``csrc/system_feasible.cu``) on the card,
    :func:`system_feasible_plain` on the CPU.  ``used0`` is the dense
    (N, 3) proposed usage, ``req_i``/``req_f`` one packed request
    (:func:`pack_request`), ``class_elig`` (K,) bool, ``host_mask`` (N,)
    bool.  Returns (2, N) bool: ``[mask, fits]``."""
    dev = used0.device
    if dev.type == "cpu":
        return system_feasible_plain(arrays, used0, req_i, req_f, class_elig,
                                     host_mask)
    if dev.type != "cuda":
        raise ValueError(f"system_feasible: unsupported device {dev}")
    n, cols = _checked_cols(arrays, used0, dev)
    k = class_elig.shape[0]
    _check("req_i", req_i, torch.int32, (1, REQ_INT_WIDTH), dev)
    _check("req_f", req_f, torch.float32, (1, REQ_FLOAT_WIDTH), dev)
    _check("class_elig", class_elig, torch.bool, (k,), dev)
    _check("host_mask", host_mask, torch.bool, (n,), dev)
    if k < 1:
        raise ValueError("class_elig must hold at least one class")
    launch = _entry("system_feasible", "nomad_system_feasible")
    out = torch.empty((2, n), dtype=torch.bool, device=dev)
    with _on(dev):
        rc = launch(
            cols, used0.data_ptr(), req_i.data_ptr(), req_f.data_ptr(),
            class_elig.data_ptr(), host_mask.data_ptr(), out.data_ptr(), n,
            arrays.attr_hash.shape[1], arrays.port_words.shape[1], k,
            _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"system_feasible launch failed: CUDA error {rc}")
    system_feasible.launches += 1
    return out


system_feasible.launches = 0


# ---------------------------------------------------------------------------
# Batched independent evals and the plan verify
# ---------------------------------------------------------------------------


class BatchScoreResult(NamedTuple):
    rows: torch.Tensor  # (B,) i32 argmax node row, -1 = no fit
    scores: torch.Tensor  # (B,) f32
    binpack: torch.Tensor  # (B,) f32
    preempted: torch.Tensor  # (B,) bool
    nodes_evaluated: torch.Tensor  # (B,) i32
    nodes_filtered: torch.Tensor  # (B,) i32
    nodes_exhausted: torch.Tensor  # (B,) i32


def _batch_result(packed) -> BatchScoreResult:
    """The (B, PACKED_WIDTH) output as a :class:`BatchScoreResult`:
    scores and binpack are views of it, rows and counters int32."""
    counters = packed[:, PACKED_EVALUATED:PACKED_WIDTH].to(torch.int32)
    return BatchScoreResult(
        rows=packed[:, PACKED_ROW].to(torch.int32),
        scores=packed[:, PACKED_SCORE],
        binpack=packed[:, PACKED_BINPACK],
        preempted=packed[:, PACKED_PREEMPT] != 0.0,
        nodes_evaluated=counters[:, 0],
        nodes_filtered=counters[:, 1],
        nodes_exhausted=counters[:, 2],
    )


def pack_batch_result(res: BatchScoreResult) -> torch.Tensor:
    """A :class:`BatchScoreResult` back as the (B, PACKED_WIDTH) float32
    the kernel writes (for comparisons)."""
    f32 = torch.float32
    return torch.stack([
        res.rows.to(f32), res.scores, res.binpack, res.preempted.to(f32),
        res.nodes_evaluated.to(f32), res.nodes_filtered.to(f32),
        res.nodes_exhausted.to(f32),
    ], dim=1)


def score_batch_plain(arrays: DeviceArrays, used, tg_counts, spread_counts,
                      penalties, req_i, req_f, class_eligs, host_masks,
                      features: Features = FULL_FEATURES) -> BatchScoreResult:
    """Plain version of the ``score_batch`` kernel: :func:`score_nodes`
    for B lanes against the shared (N, 3) ``used``, then each lane's pick
    (the reference's ``_score_and_pick``).  Its intermediates are (B, N)
    and (B, N, V): split a large batch into chunks of lanes."""
    score_batch_plain.calls += 1
    b = req_i.shape[0]
    res = score_nodes(arrays, used[None].expand(b, -1, -1), tg_counts,
                      spread_counts, penalties, req_i, req_f, class_eligs,
                      host_masks, features)
    packed, _, _ = _pick(res, arrays.eligible)
    return _batch_result(packed)


score_batch_plain.calls = 0


def score_batch(arrays: DeviceArrays, used, tg_counts, spread_counts,
                penalties, req_i, req_f, class_eligs, host_masks,
                features: Features = FULL_FEATURES) -> BatchScoreResult:
    """B independent evaluations in one launch: every node scored for each
    lane against the shared ``used``, then each lane's argmax (JAX
    ``score_batch``) — the ``score_batch`` kernel
    (``csrc/score_batch.cu``) on the card, :func:`score_batch_plain` on
    the CPU.  ``tg_counts``/``penalties``/``host_masks`` are (B, N),
    ``spread_counts`` (B, S, V), ``class_eligs`` (B, K), the requests
    packed (:func:`pack_requests`)."""
    if used.device.type == "cpu":
        return score_batch_plain(arrays, used, tg_counts, spread_counts,
                                 penalties, req_i, req_f, class_eligs,
                                 host_masks, features)
    if used.device.type != "cuda":
        raise ValueError(f"score_batch: unsupported device {used.device}")
    dev = used.device
    n = _check_matrix(arrays, used, dev)
    b, k = class_eligs.shape
    _check("tg_counts", tg_counts, torch.int32, (b, n), dev)
    _check("spread_counts", spread_counts, torch.float32,
           (b, MAX_SPREADS, MAX_SPREAD_VALUES), dev)
    _check("penalties", penalties, torch.bool, (b, n), dev)
    _check("req_i", req_i, torch.int32, (b, REQ_INT_WIDTH), dev)
    _check("req_f", req_f, torch.float32, (b, REQ_FLOAT_WIDTH), dev)
    _check("class_eligs", class_eligs, torch.bool, (b, k), dev)
    _check("host_masks", host_masks, torch.bool, (b, n), dev)
    launch = _entry("score_batch", "nomad_score_batch")
    # The kernel writes each field in its own type: rows, score bits,
    # binpack bits and the three counters as (6, B) int32, the preemption
    # flags as (B,) bytes of 0 or 1.
    out = torch.empty((6, b), dtype=torch.int32, device=dev)
    pre = torch.empty((b,), dtype=torch.bool, device=dev)
    with _on(dev):
        rc = launch(
            *_matrix_ptrs(arrays, used),
            tg_counts.data_ptr(), spread_counts.data_ptr(),
            penalties.data_ptr(), req_i.data_ptr(), req_f.data_ptr(),
            class_eligs.data_ptr(), host_masks.data_ptr(), out.data_ptr(),
            pre.data_ptr(), n, arrays.attr_hash.shape[1],
            arrays.port_words.shape[1], b, k, features.c_width,
            features.a_width, features.s_width, int(features.preempt),
            int(features.ports), _stream(dev),
        )
    if rc != 0:
        raise RuntimeError(f"score_batch launch failed: CUDA error {rc}")
    score_batch.launches += 1
    return BatchScoreResult(
        rows=out[0], scores=out[1].view(torch.float32),
        binpack=out[2].view(torch.float32), preempted=pre,
        nodes_evaluated=out[3], nodes_filtered=out[4], nodes_exhausted=out[5],
    )


score_batch.launches = 0


def verify_plan_fit_plain(arrays, rows, deltas, eligible_required):
    """Plain version of the ``verify_plan_fit`` kernel: per plan row,
    ``used[r] + delta <= totals[r]`` on all three dimensions and the node
    eligible where ``eligible_required``, with ``r = max(row, 0)``
    (clamped to the matrix, as JAX's gather is); True on padding rows
    (``row < 0``).  Returns (K,) bool."""
    verify_plan_fit_plain.calls += 1
    n = arrays.used.shape[0]
    safe = rows.clamp(0, n - 1).long()
    fits = (arrays.used[safe] + deltas <= arrays.totals[safe]).all(dim=1)
    ok = fits & (~eligible_required | arrays.eligible[safe])
    return torch.where(rows < 0, True, ok)


verify_plan_fit_plain.calls = 0


_checked_plan_cols = _ColumnMemo()


def _plan_cols(arrays, device):
    """(rows, the used, totals and eligible device pointers as a ctypes
    array) of a matrix whose three columns pass the checks; raises
    otherwise.  Checked once per set of columns."""
    cols = (arrays.used, arrays.totals, arrays.eligible)
    got = _checked_plan_cols.get(cols, device)
    if got is not None:
        return got
    n = arrays.used.shape[0]
    _check("used", arrays.used, torch.float32, (n, 3), device)
    _check("totals", arrays.totals, torch.float32, (n, 3), device)
    _check("eligible", arrays.eligible, torch.bool, (n,), device)
    return _checked_plan_cols.put(cols, device, n)


def verify_plan_fit(arrays, rows, deltas, eligible_required):
    """The plan applier's AllocsFit re-check of K plan rows against the
    matrix (JAX ``verify_plan_fit``) — the ``verify_plan_fit`` kernel
    (``csrc/verify_plan_fit.cu``) on the card,
    :func:`verify_plan_fit_plain` on the CPU.  ``arrays`` needs ``used``
    and ``totals`` (N, 3) f32 and ``eligible`` (N,) bool; ``rows`` (K,)
    int32 (-1 padding), ``deltas`` (K, 3) f32, ``eligible_required`` (K,)
    bool.  Returns (K,) bool."""
    dev = arrays.used.device
    if dev.type == "cpu":
        return verify_plan_fit_plain(arrays, rows, deltas, eligible_required)
    if dev.type != "cuda":
        raise ValueError(f"verify_plan_fit: unsupported device {dev}")
    n, cols = _plan_cols(arrays, dev)
    k = rows.shape[0]
    _check("rows", rows, torch.int32, (k,), dev)
    _check("deltas", deltas, torch.float32, (k, 3), dev)
    _check("eligible_required", eligible_required, torch.bool, (k,), dev)
    if k == 0:
        return torch.ones((0,), dtype=torch.bool, device=dev)
    launch = _entry("verify_plan_fit", "nomad_verify_plan_fit")
    out = torch.empty(k, dtype=torch.bool, device=dev)
    with _on(dev):
        rc = launch(cols, rows.data_ptr(), deltas.data_ptr(),
                    eligible_required.data_ptr(), out.data_ptr(), k, n,
                    _stream(dev))
    if rc != 0:
        raise RuntimeError(f"verify_plan_fit launch failed: CUDA error {rc}")
    verify_plan_fit.launches += 1
    return out


verify_plan_fit.launches = 0


# ---------------------------------------------------------------------------
# The node-sharded placement scan (K9)
# ---------------------------------------------------------------------------

# Words of one shard's offer in the candidate table (csrc/sharded_place.cu
# OFFER_WORDS): score bits, global row, binpack bits, preemption, the three
# counters, the best row's value hash per spread stanza, padding.
OFFER_WORDS = 12


class ShardLanes(NamedTuple):
    """One node shard's operands for :func:`sharded_place`, all on the
    shard's device: its matrix rows (``arrays``, global rows
    ``[row_offset, row_offset + n)``) and its lanes' inputs, the node-axis
    ones (``tg_counts``, ``penalties``, ``host_masks``) cut to its rows.
    Delta rows stay global."""

    arrays: DeviceArrays
    row_offset: int
    delta_rows: torch.Tensor  # (B, D) i32
    delta_vals: torch.Tensor  # (B, D, 3) f32
    tg_counts: torch.Tensor  # (B, n) i32
    spread_counts: torch.Tensor  # (B, S, V) f32
    penalties: torch.Tensor  # (B, n) bool
    req_i: torch.Tensor  # (B, REQ_INT_WIDTH) i32
    req_f: torch.Tensor  # (B, REQ_FLOAT_WIDTH) f32
    class_eligs: torch.Tensor  # (B, K) bool
    host_masks: torch.Tensor  # (B, n) bool
    lane_mask: torch.Tensor  # (B,) bool


def _shard_offers(res: ScoreResult, eligible, row_offset: int):
    """One shard's offers for a step (the plain ``sharded_place`` body):
    per lane the first maximum of its rows' scores (lowest row on ties),
    the global row, binpack and preemption there, and the three node
    counters over its rows."""
    row = torch.argmax(res.final, dim=1)
    take = row[:, None]
    return dict(
        val=res.final.gather(1, take)[:, 0],
        row=row + row_offset,
        local=row,
        bin=res.binpack.gather(1, take)[:, 0],
        pre=res.needs_preempt.gather(1, take)[:, 0],
        c0=res.feasible.sum(dim=1),
        c1=(~res.feasible & eligible[None]).sum(dim=1),
        c2=(res.feasible & ~res.fits).sum(dim=1),
    )


def sharded_place_plain(row_shards, n_placements: int,
                        features: Features = FULL_FEATURES):
    """Plain version of the ``sharded_place`` kernel for one batch row of
    node shards (a list of :class:`ShardLanes` on the CPU): each step
    every shard scores its rows and offers its best, and every shard
    reduces the offers in shard order (highest score, then the lowest
    global row; counters summed); the winner's owner applies the ask and
    the tg count, every shard the winner's spread values.  Returns (B,
    n_placements, PACKED_WIDTH) f32; dead lanes read row -1 and zeros."""
    sharded_place_plain.calls += 1
    f32 = torch.float32
    head = row_shards[0]
    req = unpack_requests(head.req_i, head.req_f)
    b = head.req_i.shape[0]
    dev = head.req_i.device
    live = head.lane_mask.clone()
    out = torch.zeros((b, n_placements, PACKED_WIDTH), dtype=f32, device=dev)
    # The lane tables live on the first shard's device; each shard scores
    # on its own with its own copy of the request.
    s_hash = req.s_value_hash.clone()
    s_counts = head.spread_counts.to(f32).clone()
    state = []
    for sh in row_shards:
        req_s = unpack_requests(sh.req_i, sh.req_f)
        state.append(dict(
            req=req_s,
            u=lane_base_usage(sh.arrays.used, sh.delta_rows, sh.delta_vals,
                              sh.row_offset),
            tg=sh.tg_counts.to(torch.int32).clone(),
            sp=_static_parts(sh.arrays, req_s, sh.penalties, sh.class_eligs,
                             sh.host_masks, features),
        ))
    for step in range(n_placements):
        offers = []
        for sh, stt in zip(row_shards, state):
            d = sh.arrays.used.device
            res = _score_step(sh.arrays, stt["req"], stt["sp"], stt["u"],
                              stt["tg"], s_hash.to(d), s_counts.to(d),
                              features)
            offers.append({key: v.to(dev) for key, v in _shard_offers(
                res, sh.arrays.eligible, sh.row_offset).items()})
        for lane in torch.nonzero(live).flatten().tolist():
            win, c = 0, [0, 0, 0]
            for s, o in enumerate(offers):
                v, r = float(o["val"][lane]), int(o["row"][lane])
                w = offers[win]
                if s == 0 or v > float(w["val"][lane]) or (
                        v == float(w["val"][lane])
                        and r < int(w["row"][lane])):
                    win = s
                c[0] += int(o["c0"][lane])
                c[1] += int(o["c1"][lane])
                c[2] += int(o["c2"][lane])
            w = offers[win]
            best = w["val"][lane]
            ok = bool(best > NEG_INF / 2)
            out[lane, step] = torch.tensor([
                float(w["row"][lane]) if ok else -1.0,
                float(best) if ok else 0.0,
                float(w["bin"][lane]) if ok else 0.0,
                float(ok and bool(w["pre"][lane])),
                c[0], c[1], c[2],
            ], dtype=f32, device=dev)
            if not ok:
                continue
            r = int(w["local"][lane])
            owner = state[win]
            owner["u"][lane, r] += owner["req"].ask[lane]
            owner["tg"][lane, r] += 1
            if features.s_width:
                nvalues = row_shards[win].arrays.attr_hash[
                    r, owner["req"].s_slot[lane].clamp(min=0).long()]
                _apply_spread_values(req, lane, s_hash, s_counts, nvalues)
    dead = ~live
    out[dead] = 0.0
    out[dead, :, PACKED_ROW] = -1.0
    return out


sharded_place_plain.calls = 0


def _check_shard(name: str, sh: ShardLanes, b: int, d: int, k: int):
    """Check one shard's operands; returns its rows."""
    dev = sh.arrays.used.device
    n = _check_matrix(sh.arrays, sh.arrays.used, dev)
    _check(f"{name}.delta_rows", sh.delta_rows, torch.int32, (b, d), dev)
    _check(f"{name}.delta_vals", sh.delta_vals, torch.float32, (b, d, 3), dev)
    _check(f"{name}.tg_counts", sh.tg_counts, torch.int32, (b, n), dev)
    _check(f"{name}.spread_counts", sh.spread_counts, torch.float32,
           (b, MAX_SPREADS, MAX_SPREAD_VALUES), dev)
    _check(f"{name}.penalties", sh.penalties, torch.bool, (b, n), dev)
    _check(f"{name}.req_i", sh.req_i, torch.int32, (b, REQ_INT_WIDTH), dev)
    _check(f"{name}.req_f", sh.req_f, torch.float32, (b, REQ_FLOAT_WIDTH), dev)
    _check(f"{name}.class_eligs", sh.class_eligs, torch.bool, (b, k), dev)
    _check(f"{name}.host_masks", sh.host_masks, torch.bool, (b, n), dev)
    _check(f"{name}.lane_mask", sh.lane_mask, torch.bool, (b,), dev)
    if sh.row_offset < 0:
        raise ValueError(f"{name}: row_offset must be >= 0")
    return n


# (batch row, node shard) pairs one ``sharded_place`` launch covers
# (csrc/sharded_place.cu SP_MAX_PAIRS) and node shards a batch row may have
# (SP_MAX_SHARDS).
SHARDED_MAX_PAIRS = 16
SHARDED_MAX_SHARDS = 32


class ShardedLaunchPlan(NamedTuple):
    """What one ``sharded_place`` dispatch issues, step by step
    (:func:`_sharded_launch_plan`)."""

    # [step] -> ((device, ((batch row, shard), ...)), ...): one launch of
    # steps 0..P each, in issue order.
    launches: tuple
    # [step] -> ((source device, destination device, batch row, first
    # shard, end shard), ...): the offer copies issued after the step's
    # launches, one per run of consecutive shards of a row on the source.
    copies: tuple


def _sharded_launch_plan(groups, n_placements: int) -> ShardedLaunchPlan:
    """The launches and offer copies of a ``sharded_place`` dispatch over
    ``groups``: one list of ``torch.device`` per batch row, its node
    shards' devices in shard order.

    Each step every card launches once over all the (batch row, shard)
    pairs it holds (more than ``SHARDED_MAX_PAIRS`` pairs take several
    launches); the last step only writes the result, so there only the
    launches that hold a row's first shard run.  Shards of one card share
    the card's offer table; after each step but the last, the offers of a
    row's shards go to each other card that holds a shard of that row and
    launches at the next step, one copy per run of consecutive shards."""
    chunks = {}
    for i, row in enumerate(groups):
        for j, dev in enumerate(row):
            chunks.setdefault(dev, []).append((i, j))
    per_card = []
    for dev, pairs in chunks.items():
        for lo in range(0, len(pairs), SHARDED_MAX_PAIRS):
            per_card.append((dev, tuple(pairs[lo:lo + SHARDED_MAX_PAIRS])))
    every = tuple(per_card)
    last = tuple(c for c in per_card if any(j == 0 for _, j in c[1]))
    launches = tuple(every if step < n_placements else last
                     for step in range(n_placements + 1))
    copies = []
    for step in range(n_placements + 1):
        step_copies = []
        if step < n_placements:
            nxt = launches[step + 1]
            for i, row in enumerate(groups):
                # Cards that launch at the next step over a pair of row i.
                dsts = []
                for dev, pairs in nxt:
                    if dev not in dsts and any(r == i for r, _ in pairs):
                        dsts.append(dev)
                j = 0
                while j < len(row):
                    src, end = row[j], j + 1
                    while end < len(row) and row[end] == src:
                        end += 1
                    for dst in dsts:
                        if dst != src:
                            step_copies.append((src, dst, i, j, end))
                    j = end
        copies.append(tuple(step_copies))
    return ShardedLaunchPlan(launches, tuple(copies))


class _SPPair(ctypes.Structure):
    """One pair's descriptor (csrc/sharded_place.cu ``SPPair``)."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in (
            "eligible", "attr_hash", "attr_num", "attr_ver", "class_id",
            "dev_total", "dev_used", "port_words", "dyn_used")]
        + [("a", ctypes.c_int), ("w", ctypes.c_int)]
        + [(f, ctypes.c_void_p) for f in (
            "totals", "used", "prio_used", "delta_rows", "delta_vals",
            "tg_counts", "spread_counts", "penalties", "req_i", "req_f",
            "class_eligs", "host_masks", "lane_mask", "scratch", "out")]
        + [(f, ctypes.c_int) for f in (
            "n", "off", "b", "d", "k", "row", "shard", "shards")])


def sharded_place_shape(n: int, lanes: int, d: int, n_placements: int,
                        features: Features) -> dict:
    """The launch shape ``csrc/sharded_place.cu`` takes for a launch over
    pairs of at most ``n`` rows, ``lanes`` lanes in all and ``d`` delta
    rows a lane: ``cluster`` (CTAs a (lane, pair) runs on), ``span`` (rows
    a CTA owns), ``cta_bytes`` (each CTA's state between launches),
    ``smem`` (dynamic shared memory bytes) and ``tier`` (0 bench, 1 full
    widths).  Needs the built library (the card)."""
    key = ("sharded_place", n, lanes, d, n_placements, features)
    got = _shapes.get(key)
    if got is None:
        buf = (ctypes.c_longlong * 5)()
        _entry("sharded_place", "nomad_sharded_place_shape")(
            n, lanes, d, n_placements, features.c_width, features.a_width,
            features.s_width, int(features.preempt), int(features.ports), buf)
        got = dict(cluster=buf[0], span=buf[1], cta_bytes=buf[2],
                   smem=buf[3], tier=buf[4])
        _shapes[key] = got
    return got


def _pair_descriptor(sh: ShardLanes, row: int, shard: int, shards: int,
                     scratch: int, out) -> _SPPair:
    """Pair (``row``, ``shard``)'s descriptor; ``scratch`` is the address
    of its CTAs' state, ``out`` the row's result on its first shard (else
    None)."""
    a = sh.arrays
    b, d = sh.delta_rows.shape
    return _SPPair(
        a.eligible.data_ptr(), a.attr_hash.data_ptr(), a.attr_num.data_ptr(),
        a.attr_ver.data_ptr(), a.class_id.data_ptr(), a.dev_total.data_ptr(),
        a.dev_used.data_ptr(), a.port_words.data_ptr(), a.dyn_used.data_ptr(),
        a.attr_hash.shape[1], a.port_words.shape[1], a.totals.data_ptr(),
        a.used.data_ptr(),
        a.prio_used.data_ptr(), sh.delta_rows.data_ptr(),
        sh.delta_vals.data_ptr(), sh.tg_counts.data_ptr(),
        sh.spread_counts.data_ptr(), sh.penalties.data_ptr(),
        sh.req_i.data_ptr(), sh.req_f.data_ptr(), sh.class_eligs.data_ptr(),
        sh.host_masks.data_ptr(), sh.lane_mask.data_ptr(), scratch,
        None if out is None else out.data_ptr(),
        a.used.shape[0], sh.row_offset, b, d, sh.class_eligs.shape[1], row,
        shard, shards)


def sharded_place(groups, n_placements: int,
                  features: Features = FULL_FEATURES):
    """The node-sharded placement scan — the ``sharded_place`` kernel
    (``csrc/sharded_place.cu``) on the cards, :func:`sharded_place_plain`
    on the CPU.  ``groups`` is one list of :class:`ShardLanes` per batch
    row (the node shards of that row, in row order, all of one device
    type).  Returns one (B_row, n_placements, PACKED_WIDTH) f32 tensor per
    batch row, on the device of that row's first shard.

    On the cards a dispatch is ``n_placements + 1`` steps, each one launch
    a card over every (batch row, shard) pair there, on the card's current
    stream (:func:`_sharded_launch_plan`).  Shards of one card read each
    other's offers from one table on that card; offers bound for another
    card are copied there after the step's launch, and the destination's
    next launch waits on the source's event."""
    devs = {sh.arrays.used.device.type for row in groups for sh in row}
    if len(devs) != 1:
        raise ValueError(f"sharded_place: mixed device types {sorted(devs)}")
    if devs == {"cpu"}:
        for row in groups:
            _check_delta_width("sharded_place", row[0].delta_rows)
        return [sharded_place_plain(row, n_placements, features)
                for row in groups]
    if devs != {"cuda"}:
        raise ValueError(f"sharded_place: unsupported device {devs}")
    if not 1 <= n_placements <= 64:
        raise ValueError("n_placements must be in [1, 64]")
    if _entry("sharded_place", "nomad_sharded_pair_bytes")() != ctypes.sizeof(_SPPair):
        raise RuntimeError("sharded_place: csrc/sharded_place.cu's SPPair "
                           "disagrees with ops/kernels.py _SPPair")
    launch = _entry("sharded_place", "nomad_sharded_place")
    n_rows = len(groups)
    shards_max = max(len(row) for row in groups)
    if shards_max > SHARDED_MAX_SHARDS:
        raise ValueError(f"sharded_place: {shards_max} node shards a batch "
                         f"row, at most {SHARDED_MAX_SHARDS}")
    b_max = d_max = 0
    for row in groups:
        head = row[0]
        b, d = head.delta_rows.shape
        k = head.class_eligs.shape[1]
        _check_delta_width("sharded_place", head.delta_rows)
        for si, sh in enumerate(row):
            _check_shard(f"shard {si}", sh, b, d, k)
        b_max, d_max = max(b_max, b), max(d_max, d)
    plan = _sharded_launch_plan(
        [[sh.arrays.used.device for sh in row] for row in groups],
        n_placements)
    tables, outs, launches = {}, [], []
    for row in groups:
        with _on(row[0].arrays.used.device):
            outs.append(torch.empty(
                (row[0].delta_rows.shape[0], n_placements, PACKED_WIDTH),
                dtype=torch.float32, device=row[0].arrays.used.device))
    for dev, pairs in plan.launches[0]:
        lanes = sum(groups[i][j].delta_rows.shape[0] for i, j in pairs)
        n_max = max(groups[i][j].arrays.used.shape[0] for i, j in pairs)
        with _on(dev):
            shape = sharded_place_shape(n_max, lanes, d_max, n_placements,
                                        features)
            if dev not in tables:
                tables[dev] = torch.empty(
                    (2, n_rows, shards_max, b_max, OFFER_WORDS),
                    dtype=torch.int32, device=dev)
            # One scratch for the launch: each pair's CTAs' state, b x C x
            # cta_bytes bytes a pair, back to back.
            per_lane = shape["cluster"] * shape["cta_bytes"]
            scratch = torch.empty((lanes * per_lane,), dtype=torch.uint8,
                                  device=dev)
            descs, at = (_SPPair * len(pairs))(), scratch.data_ptr()
            for q, (i, j) in enumerate(pairs):
                sh = groups[i][j]
                descs[q] = _pair_descriptor(sh, i, j, len(groups[i]), at,
                                            outs[i] if j == 0 else None)
                at += sh.delta_rows.shape[0] * per_lane
        launches.append(((dev, pairs), descs, scratch))
    tail = (features.c_width, features.a_width, features.s_width,
            int(features.preempt), int(features.ports))
    # Each launch's arguments but the step and the stream, fixed for the
    # dispatch.
    fixed = {chunk: (ctypes.addressof(descs), len(chunk[1]),
                    tables[chunk[0]].data_ptr(), n_rows, shards_max, b_max,
                    n_placements)
            for chunk, descs, _ in launches}
    events = {}
    for step in range(n_placements + 1):
        waits = {}
        if step > 0:
            for src, dst, *_ in plan.copies[step - 1]:
                waits.setdefault(dst, set()).add(src)
        for chunk in plan.launches[step]:
            dev = chunk[0]
            with _on(dev):
                if dev in waits:
                    stream = torch.cuda.current_stream(dev)
                    for src in waits[dev]:
                        stream.wait_event(events[src])
                rc = launch(*fixed[chunk], step, *tail,
                                             _stream(dev))
            if rc != 0:
                raise RuntimeError(
                    f"sharded_place launch failed: CUDA error {rc}")
            sharded_place.launches += 1
        sources = []
        for src, dst, i, lo, hi in plan.copies[step]:
            with _on(src):
                tables[dst][step & 1, i, lo:hi].copy_(
                    tables[src][step & 1, i, lo:hi], non_blocking=True)
            sharded_place.copies += 1
            if src not in sources:
                sources.append(src)
        for src in sources:
            with _on(src):
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(src))
                events[src] = ev
    return outs


sharded_place.launches = 0
# Offer copies between cards' tables (the exchange; data movement).
sharded_place.copies = 0


# Lanes a sharded_usage call takes (csrc/sharded_place.cu SU_MAX_LANES).
SHARDED_USAGE_MAX_LANES = 65536


def sharded_usage_plain(used, packed, req_f, n_batch: int,
                        row_offset: int = 0):
    """Plain version of the ``sharded_usage`` kernel: ``used`` (one
    shard's (n, 3) rows from global row ``row_offset`` on) plus every
    pick's ask, the picks being step 0's rows of the gathered (B, P,
    PACKED_WIDTH) result ``packed`` and the asks ``req_f``'s.  Each batch
    row's part sums its lanes' asks in lane order; the parts add up in
    batch-row order (the reference's scatter, then ``psum`` over
    ``batch``)."""
    sharded_usage_plain.calls += 1
    n = used.shape[0]
    b = packed.shape[0]
    per = b // n_batch
    rows = (packed[:, 0, PACKED_ROW].to(torch.int64) - row_offset).tolist()
    off = REQ_FLOAT_OFF["ask"][0]
    asks = req_f[:, off:off + 3].to(used.device)
    delta = torch.zeros_like(used)
    for i in range(n_batch):
        part = torch.zeros_like(used)
        for lane in range(i * per, (i + 1) * per):
            if 0 <= rows[lane] < n:
                part[rows[lane]] += asks[lane]
        delta = delta + part
    return used + delta


sharded_usage_plain.calls = 0


def _check_usage_lanes(b: int) -> None:
    """Both devices refuse more lanes than the card's kernel lists (its
    shared-memory list of picks holds 16-bit lanes), so a step the CPU
    takes also launches on the card."""
    if b > SHARDED_USAGE_MAX_LANES:
        raise ValueError(f"sharded_usage: {b} lanes, at most "
                         f"{SHARDED_USAGE_MAX_LANES}")


def sharded_usage(used, packed, req_f, n_batch: int, row_offset: int = 0):
    """The sharded step's usage update on one node shard — the
    ``sharded_usage`` kernel (``csrc/sharded_place.cu``) on the card,
    :func:`sharded_usage_plain` on the CPU.  At most
    ``SHARDED_USAGE_MAX_LANES`` lanes.  Every operand lies on the shard's
    device; returns a new (n, 3) f32 tensor there."""
    b = packed.shape[0]
    _check_usage_lanes(b)
    dev = used.device
    if dev.type == "cpu":
        return sharded_usage_plain(used, packed, req_f, n_batch, row_offset)
    if dev.type != "cuda":
        raise ValueError(f"sharded_usage: unsupported device {dev}")
    n = used.shape[0]
    p = packed.shape[1]
    _check("used", used, torch.float32, (n, 3), dev)
    _check("packed", packed, torch.float32, (b, p, PACKED_WIDTH), dev)
    _check("req_f", req_f, torch.float32, (b, REQ_FLOAT_WIDTH), dev)
    if n_batch < 1 or b % n_batch or row_offset < 0:
        raise ValueError("sharded_usage: bad n_batch or row_offset")
    launch = _entry("sharded_place", "nomad_sharded_usage")
    out = torch.empty_like(used)
    with _on(dev):
        rc = launch(used.data_ptr(), packed.data_ptr(), req_f.data_ptr(),
                    out.data_ptr(), n, row_offset, b, p, n_batch,
                    _stream(dev))
    if rc != 0:
        raise RuntimeError(f"sharded_usage launch failed: CUDA error {rc}")
    sharded_usage.launches += 1
    return out


sharded_usage.launches = 0


def reset_counts() -> None:
    """Zero every launch and call count (the smoke reads them around the
    main path)."""
    fused_place.launches = 0
    place_batch.launches = 0
    allocs_fit_verify.launches = 0
    allocs_fit_verify.window_launches = 0
    sharded_place.launches = 0
    sharded_place.copies = 0
    sharded_place_plain.calls = 0
    sharded_usage.launches = 0
    sharded_usage_plain.calls = 0
    system_feasible.launches = 0
    score_batch.launches = 0
    verify_plan_fit.launches = 0
    place_lanes.calls = 0
    verify_lanes.calls = 0
    system_feasible_plain.calls = 0
    score_batch_plain.calls = 0
    verify_plan_fit_plain.calls = 0


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def fused_place_batch(arrays: DeviceArrays, used, delta_rows, delta_vals,
                      tg_counts, spread_counts, penalties, req_i, req_f,
                      class_eligs, host_masks, lane_mask, n_placements: int,
                      features: Features = FULL_FEATURES):
    """The fused dispatch (JAX ``_fused_place_batch_impl``): B eval lanes
    — feasibility → binpack → spread/affinity → preemption → placement
    scan — then the cross-lane AllocsFit verify column.  Two launches on
    the card.  Returns (B, n_placements, FUSED_PACKED_WIDTH) f32."""
    packed = fused_place(arrays, used, delta_rows, delta_vals, tg_counts,
                         spread_counts, penalties, req_i, req_f, class_eligs,
                         host_masks, lane_mask, n_placements, features)
    return allocs_fit_verify(arrays.totals, used, packed, req_f, delta_rows,
                             delta_vals, lane_mask)


class PlacementResult(NamedTuple):
    rows: np.ndarray  # (P,) i32 chosen node row, -1 = failed
    scores: np.ndarray  # (P,) f32
    binpack: np.ndarray  # (P,) f32
    preempted: np.ndarray  # (P,) bool
    nodes_evaluated: np.ndarray  # (P,) i32
    nodes_filtered: np.ndarray  # (P,) i32
    nodes_exhausted: np.ndarray  # (P,) i32


def place_task_group(arrays: DeviceArrays, req: SchedRequest, used0,
                     tg_count, spread_counts, penalty, class_elig, host_mask,
                     n_placements: int,
                     features: Features = FULL_FEATURES) -> PlacementResult:
    """Place ``n_placements`` allocs of one task group against a dense
    proposed usage ``used0`` (N, 3): the ``fused_place`` kernel at B=1
    with no lane deltas (the solo path of the stack).  ``req`` is one
    numpy request; the node-axis inputs are tensors on the matrix's
    device.  Returns host-side numpy results."""
    dev = used0.device
    ri, rf = pack_request(req, dev)
    packed = fused_place(
        arrays, used0.contiguous(),
        torch.full((1, 1), -1, dtype=torch.int32, device=dev),
        torch.zeros((1, 1, 3), dtype=torch.float32, device=dev),
        tg_count[None].contiguous(),
        spread_counts[None].contiguous(),
        penalty[None].contiguous(),
        ri, rf,
        class_elig[None].contiguous(), host_mask[None].contiguous(),
        torch.ones((1,), dtype=torch.bool, device=dev),
        n_placements, features,
    )
    out = packed[0].cpu().numpy()
    return PlacementResult(
        rows=out[:, PACKED_ROW].astype(np.int32),
        scores=out[:, PACKED_SCORE],
        binpack=out[:, PACKED_BINPACK],
        preempted=out[:, PACKED_PREEMPT] != 0.0,
        nodes_evaluated=out[:, PACKED_EVALUATED].astype(np.int32),
        nodes_filtered=out[:, PACKED_FILTERED].astype(np.int32),
        nodes_exhausted=out[:, PACKED_EXHAUSTED].astype(np.int32),
    )
