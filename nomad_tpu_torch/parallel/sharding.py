"""Batch assembly for ``ops.kernels.score_batch``.

The port's copies of the JAX package's ``stack_requests`` and
``build_batch_inputs`` (``nomad_tpu/parallel/sharding.py``).  The sharded
scheduling steps of that module (a node axis split over several cards)
are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.encode import SchedRequest, pow2_bucket
from ..ops.kernels import pack_requests


def _stack(reqs: Sequence[SchedRequest]) -> SchedRequest:
    return SchedRequest(*[np.stack(f) for f in zip(*reqs)])


def stack_requests(reqs: Sequence[SchedRequest]) -> SchedRequest:
    """Stack B per-eval requests into one batched request (leading B axis).

    Trailing padding in the per-predicate dimensions (constraints,
    affinities, static ports, datacenters) is narrowed to the batch's
    actual maximum, pow2-bucketed, as the reference does for its gathers.
    The kernels take the full-width packed form instead
    (:func:`build_batch_inputs`); narrowing changes no result, since the
    dropped slots are all inactive."""
    stacked = _stack(reqs)

    def width(active: np.ndarray, cap: int) -> int:
        count = int(active.sum(axis=1).max()) if len(active) else 0
        return min(cap, pow2_bucket(max(1, count)))

    cw = width(stacked.c_slot >= 0, stacked.c_slot.shape[1])
    aw = width(stacked.a_slot >= 0, stacked.a_slot.shape[1])
    pw = width(stacked.p_static >= 0, stacked.p_static.shape[1])
    dw = width(stacked.dc_hash != 0, stacked.dc_hash.shape[1])
    return stacked._replace(
        c_slot=stacked.c_slot[:, :cw],
        c_op=stacked.c_op[:, :cw],
        c_hash=stacked.c_hash[:, :cw],
        c_num=stacked.c_num[:, :cw],
        a_slot=stacked.a_slot[:, :aw],
        a_op=stacked.a_op[:, :aw],
        a_hash=stacked.a_hash[:, :aw],
        a_num=stacked.a_num[:, :aw],
        a_weight=stacked.a_weight[:, :aw],
        p_static=stacked.p_static[:, :pw],
        dc_hash=stacked.dc_hash[:, :dw],
    )


def build_batch_inputs(matrix, requests: Sequence[SchedRequest],
                       device="cuda") -> dict:
    """The batched operands ``score_batch`` takes, for B evals with no
    in-flight plan state, as tensors on ``device``: zero TG counts and
    spread counts, no penalties, all classes eligible, no host mask, and
    the requests packed (``req_i``/``req_f``, :func:`pack_requests`).
    ``reqs`` is the stacked numpy request of :func:`stack_requests`.  The
    class-eligibility width is ``pow2_bucket`` of the matrix's class
    count, as in the reference."""
    dev = resolve_device(device)
    b = len(requests)
    n = matrix.capacity
    pad = pow2_bucket(max(1, len(matrix.class_ids)))
    ri, rf = pack_requests(_stack(requests))
    return dict(
        reqs=stack_requests(requests),
        req_i=torch.from_numpy(ri).to(dev),
        req_f=torch.from_numpy(rf).to(dev),
        tg_counts=torch.zeros((b, n), dtype=torch.int32, device=dev),
        spread_counts=torch.zeros(
            (b,) + np.asarray(requests[0].s_value_hash).shape,
            dtype=torch.float32, device=dev),
        penalties=torch.zeros((b, n), dtype=torch.bool, device=dev),
        class_eligs=torch.ones((b, pad), dtype=torch.bool, device=dev),
        host_masks=torch.ones((b, n), dtype=torch.bool, device=dev),
    )
