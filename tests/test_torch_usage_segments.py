"""The staged usage update of ``csrc/sharded_place.cu`` (``sharded_usage``),
on the CPU.

The kernel cannot run here, so its algorithm is modelled in numpy below,
step for step:

* CTA ranges: each CTA owns a span of about n / SMs rows, a multiple of
  4, at most SU_THREADS (the launcher's ``su_span``);
* chunked ballot compaction: every CTA reads the B picks in groups of
  SU_GROUP chunks of SU_THREADS lanes; a chunk's warps ballot the lanes
  whose pick falls in the CTA's rows, and one prefix sum a group over
  the counts in (chunk, warp) order places each lane at its warp's start
  plus its rank in the ballot — the list must come out in lane order;
* batch rows as segments of the list: with few batch rows, one group of
  row threads a batch row walks its segment (a row's parts in parallel),
  else one thread a row walks the whole list, closing a part when the
  batch row changes; each row's asks added in list order in float32;
* windows of staged asks: each group's next ``sub`` entries staged at
  once, a stage index past its segment's end keeping an earlier
  window's entry (or zeros on row 0); a window whose entries all lie on
  one row is added by that row's walker 16 at a time; else each full
  16-entry block on one row is a run that its row's walker adds 16 at a
  time, and any other block is walked entry by entry (16 at a time: no
  part check where the 16th entry is of the current batch row);
* each row's parts added in batch-row order; out = used + delta.

The model agrees bit for bit with ``sharded_usage_plain`` (the plain
version the kernel is held to on the card) on the cases of
``tests/torch_edge_cases.py`` that the card tests use, on the card's SM
count and on a small one (spans of 256 rows: one group, lists of many
windows), and on hypothesis-drawn streams; and the wrapper refuses more
lanes than the kernel's list holds on the CPU as on the card.
"""

import collections

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_edge_cases as edge_cases
from nomad_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

SU_THREADS = 256
SU_WARPS = SU_THREADS // 32
SU_GROUP = 8
SU_MAX_G = 8
SU_WIN = SU_THREADS * 4
H100_SMS = 132


def su_span(n, sms):
    """Rows a CTA owns (the launcher's ``su_span``)."""
    return min(SU_THREADS, ((n + sms - 1) // sms + 3) // 4 * 4)


def cta_list(picks, first, rows):
    """The CTA's list of (lane, row) as the ballots and prefix sums build
    it, from the picks as the kernel reads them (an ``(int)`` cast)."""
    b = picks.shape[0]
    g_all = picks.astype(np.int32)
    lanes, lrows = np.full(b, -1, np.int64), np.full(b, -1, np.int64)
    total = 0
    for base in range(0, b, SU_THREADS * SU_GROUP):
        lane = base + np.arange(SU_GROUP * SU_THREADS).reshape(
            SU_GROUP, SU_WARPS, 32)
        valid = lane < b
        g = np.where(valid, g_all[np.minimum(lane, b - 1)], -1)
        hit = valid & (g >= first) & (g < first + rows)
        counts = hit.sum(axis=2).reshape(-1)  # (chunk, warp) order
        starts = total + np.cumsum(counts) - counts
        total += int(counts.sum())
        for u in range(SU_GROUP):
            for w in range(SU_WARPS):
                mask = hit[u, w]
                # A hit lane's place: its warp's start plus the hit lanes
                # below it in the ballot.
                at = starts[u * SU_WARPS + w] + np.cumsum(mask)[mask] - 1
                lanes[at] = lane[u, w][mask]
                lrows[at] = g[u, w][mask] - first
    lanes, lrows = lanes[:total], lrows[:total]
    assert (np.diff(lanes) > 0).all(), "the list is not in lane order"
    assert ((lrows >= 0) & (lrows < rows)).all()
    return lanes, lrows


def su_groups(n_batch, span):
    """Batch rows walked in parallel (the launcher's ``groups``): one
    warp-aligned group of row threads a batch row where they fit."""
    span_w = (span + 31) // 32 * 32
    if n_batch <= SU_MAX_G and n_batch * span_w <= SU_THREADS:
        return n_batch
    return 1


def su_fetch(pre, prow, lanes, lrows, ask_of, segs, groups, sub, k, per):
    """Window ``k``'s entries into the staging registers: stage index
    ``idx`` holds group ``idx // sub``'s entry ``segs[g] + k * sub + idx %
    sub`` as (ask, batch row) and its row; an index past its segment's
    end keeps what it held (an earlier window's entry, or zeros on row 0
    before the first)."""
    for g in range(groups):
        j = segs[g] + k * sub + np.arange(sub)
        ok = j < segs[g + 1]
        idx = g * sub + np.flatnonzero(ok)
        lane = lanes[j[ok]]
        pre[idx, :3] = ask_of[lane]
        pre[idx, 3] = g if groups > 1 else lane // per
        prow[idx] = lrows[j[ok]]


def window_marks(stage_row, g, sub, left):
    """A group's 16-entry blocks of one window: each block's row where
    all 16 of its entries lie on one row, else -1 (a block cut short by
    the segment's end too), and whether every staged entry of the window
    lies on the row of its first (``left``: the segment's entries from
    this window's first on)."""
    blocks = stage_row[g * sub:(g + 1) * sub].reshape(-1, 16)
    n = np.minimum(16, min(sub, left) - 16 * np.arange(sub // 16))
    first = stage_row[g * sub]
    one = (n == 16) & (blocks == blocks[:, :1]).all(1)
    runs = np.where(one, blocks[:, 0], -1)
    uniform = True
    for blk in np.flatnonzero(n > 0):
        if n[blk] == 16:
            uniform &= bool(one[blk] and blocks[blk, 0] == first)
        else:
            uniform &= bool((blocks[blk, :n[blk]] == first).all())
    return runs, uniform


def cta_walk(lanes, lrows, ask_of, rows, span, n_batch, per, paths):
    """One CTA's deltas (rows, 3) f32 as its walk adds them: windows of
    each group's next ``sub`` entries staged with stale fill past a
    segment's end; a window on one row added by that row's walker 16 at
    a time (then its tail one by one); else each full 16-entry block on
    one row added 16 at a time by its row's walker (a block whose last
    entry is of the current batch row without a part check), any other
    block entry by entry.  ``paths`` counts what the walk took."""
    b = per * n_batch
    groups = su_groups(n_batch, span)
    segs = np.searchsorted(lanes, np.arange(groups + 1) * (b // groups))
    sub = SU_WIN >> (groups - 1).bit_length()
    windows = max(-(-(segs[g + 1] - segs[g]) // sub) for g in range(groups))
    pre = np.zeros((SU_WIN, 4), np.float32)
    prow = np.zeros(SU_WIN, np.int64)
    d = np.zeros((groups, rows, 3), np.float32)
    part = np.zeros((groups, rows, 3), np.float32)
    cur = np.full((groups, rows), -1)

    def add1(g, r, v):
        if v[3] != cur[g, r]:
            d[g, r] = d[g, r] + part[g, r]
            part[g, r] = 0.0
            cur[g, r] = v[3]
        part[g, r] = part[g, r] + v[:3]

    def add16(g, r, v):
        if v[15, 3] == cur[g, r]:
            paths["run"] += 1
            for e in range(16):
                part[g, r] = part[g, r] + v[e, :3]
        else:
            paths["run_closing"] += 1
            for e in range(16):
                add1(g, r, v[e])

    su_fetch(pre, prow, lanes, lrows, ask_of, segs, groups, sub, 0, per)
    for k in range(windows):
        stage, stage_row = pre.copy(), prow.copy()
        if k + 1 < windows:
            su_fetch(pre, prow, lanes, lrows, ask_of, segs, groups, sub,
                     k + 1, per)
        for g in range(groups):
            left = segs[g + 1] - segs[g] - k * sub
            length = max(0, min(sub, left))
            st, sr = stage[g * sub:(g + 1) * sub], stage_row[g * sub:]
            runs, uniform = window_marks(stage_row, g, sub, left)
            if length > 0 and uniform:
                paths["uniform"] += 1
                r = sr[0]
                assert r < rows
                for blk in range(length // 16):
                    add16(g, r, st[16 * blk:16 * blk + 16])
                for i in range(length // 16 * 16, length):
                    add1(g, r, st[i])
                continue
            for blk in range(-(-length // 16)):
                r = runs[blk]
                if r >= 0:
                    assert r < rows
                    add16(g, r, st[16 * blk:16 * blk + 16])
                    continue
                paths["entries"] += 1
                # A block cut short: stale stage entries past its end.
                paths["stale"] += length < 16 * blk + 16 and k > 0
                for i in range(16 * blk, min(length, 16 * blk + 16)):
                    add1(g, sr[i], st[i])
    delta = np.zeros((rows, 3), np.float32)
    for g in range(groups):
        delta = delta + (d[g] + part[g])
    return delta


def model_usage(used, packed, req_f, n_batch, row_offset, sms=H100_SMS,
                paths=None):
    """The kernel's algorithm on numpy operands; returns (n, 3) f32."""
    n = used.shape[0]
    b = packed.shape[0]
    per = b // n_batch
    ask = tk.REQ_FLOAT_OFF["ask"][0]
    ask_of = req_f[:, ask:ask + 3]
    picks = packed[:, 0, tk.PACKED_ROW]
    span = su_span(n, sms)
    paths = collections.Counter() if paths is None else paths
    out = np.empty_like(used)
    for lo in range(0, n, span):
        rows = min(span, n - lo)
        lanes, lrows = cta_list(picks, row_offset + lo, rows)
        delta = np.zeros((rows, 3), np.float32)
        if len(lanes):
            delta = cta_walk(lanes, lrows, ask_of, rows, span, n_batch, per,
                             paths)
        out[lo:lo + rows] = used[lo:lo + rows] + delta
    return out


def plain_usage(used, packed, req_f, n_batch, row_offset):
    return tk.sharded_usage_plain(torch.from_numpy(used),
                                  torch.from_numpy(packed),
                                  torch.from_numpy(req_f), n_batch,
                                  row_offset).numpy()


def operands(w, p=1):
    return edge_cases.usage_operands(w, tk.PACKED_WIDTH, tk.REQ_FLOAT_WIDTH,
                                     tk.REQ_FLOAT_OFF["ask"][0], p=p)


def assert_bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("sms", [H100_SMS, 7])
@pytest.mark.parametrize("case", edge_cases.USAGE_CASES)
def test_model_matches_plain_on_cases(case, sms):
    """The cases the card tests hold the kernel to: bit for bit."""
    w = edge_cases.usage_case(case)
    used, packed, req_f = operands(w)
    want = plain_usage(used, packed, req_f, w["n_batch"], w["row_offset"])
    got = model_usage(used, packed, req_f, w["n_batch"], w["row_offset"],
                      sms=sms)
    assert_bits_equal(got, want)
    # A row without a pick adds 0.0: -0.0 comes out +0.0.
    assert (np.signbit(want[::97]) == (want[::97] < 0)).all()


def test_cases_cover_what_they_name():
    n = lambda c: edge_cases.USAGE_SHAPES[c][2]  # noqa: E731
    assert edge_cases.USAGE_SHAPES["limit"][0] == tk.SHARDED_USAGE_MAX_LANES
    assert n("ragged") % su_span(n("ragged"), H100_SMS) != 0
    w = edge_cases.usage_case("one_row")
    assert len(set(w["picks"].tolist())) == 1 and w["n_batch"] == 2
    # One CTA's list past one window of asks.
    assert w["picks"].shape[0] > SU_THREADS
    w = edge_cases.usage_case("outside")
    off, rows = w["row_offset"], edge_cases.USAGE_SHAPES["outside"][2]
    assert not ((w["picks"] >= off) & (w["picks"] < off + rows)).any()
    assert (edge_cases.usage_case("all_failed")["picks"] == -1).all()
    b, nb, rows, off = edge_cases.USAGE_SHAPES["last_shard"]
    assert off + rows == edge_cases.USAGE_MATRIX_ROWS
    # Both walks: a group a batch row (the card's SM count; three batch
    # rows in b63) and one thread a row over every batch row (few SMs).
    assert su_groups(2, su_span(n("b4096"), H100_SMS)) == 2
    assert su_groups(3, su_span(n("b63"), H100_SMS)) == 3
    assert su_groups(2, su_span(n("b4096"), 7)) == 1


@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_runs_case_walks_every_path(sms):
    """The runs case reaches every path of the walk: windows on one row,
    runs of 16 entries on one row (without a part check, and with one: a
    row's first, or across the batch rows), blocks walked entry by
    entry, and a block cut short by its segment's end beside an earlier
    window's stale entries."""
    w = edge_cases.usage_case("runs")
    used, packed, req_f = operands(w)
    paths = collections.Counter()
    got = model_usage(used, packed, req_f, w["n_batch"], w["row_offset"],
                      sms=sms, paths=paths)
    assert_bits_equal(got, plain_usage(used, packed, req_f, w["n_batch"],
                                       w["row_offset"]))
    for kind in ("uniform", "run", "run_closing", "entries", "stale"):
        assert paths[kind] > 0, kind


def test_grouping_case_depends_on_the_order():
    """The grouping case's sums change with another grouping (all asks of
    a row in one part, in reverse lane order): an unordered reduction
    would not equal the plain version there."""
    w = edge_cases.usage_case("grouping")
    used, packed, req_f = operands(w)
    off, b = w["row_offset"], len(w["picks"])
    want = plain_usage(used, packed, req_f, w["n_batch"], off)
    rows = w["picks"].astype(np.int64) - off
    sums = np.zeros_like(used)
    for lane in reversed(range(b)):
        if 0 <= rows[lane] < used.shape[0]:
            sums[rows[lane]] += req_f[lane, :3]
    other = used + sums
    assert not np.array_equal(other, want)


VALUES = [2.0 ** 24, 1.0, -1.0, 0.5, 3.0, 1e-3, 0.0, -0.0, 2e7, -3e7]


@st.composite
def usage_streams(draw):
    """Few rows, so picks collide; a hot row; picks outside the window, -1
    and past the matrix; order-sensitive asks."""
    n_batch = draw(st.sampled_from([1, 2, 3]))
    b = n_batch * draw(st.integers(1, 24))
    n = draw(st.integers(1, 40))
    off = draw(st.integers(0, 9))
    hot = off + draw(st.integers(0, n - 1))
    pick = st.one_of(st.just(hot), st.integers(off, off + n - 1),
                     st.sampled_from([-1, 0, off + n, off + n + 3]))
    picks = np.array(draw(st.lists(pick, min_size=b, max_size=b)),
                     np.float32)
    asks = np.array(draw(st.lists(st.sampled_from(VALUES), min_size=3 * b,
                                  max_size=3 * b)), np.float32).reshape(b, 3)
    used = np.array(draw(st.lists(st.sampled_from(VALUES), min_size=3 * n,
                                  max_size=3 * n)), np.float32).reshape(n, 3)
    sms = draw(st.sampled_from([1, 2, 5, H100_SMS]))
    return dict(used=used, picks=picks, asks=asks, n_batch=n_batch,
                row_offset=off), sms


@settings(max_examples=120, deadline=None, derandomize=True, database=None)
@given(usage_streams())
def test_model_matches_plain_on_drawn_streams(drawn):
    w, sms = drawn
    used, packed, req_f = operands(w, p=2)
    want = plain_usage(used, packed, req_f, w["n_batch"], w["row_offset"])
    got = model_usage(used, packed, req_f, w["n_batch"], w["row_offset"],
                      sms=sms)
    assert_bits_equal(got, want)


def test_wrapper_refuses_lanes_past_the_limit_on_the_cpu():
    """The wrapper takes SHARDED_USAGE_MAX_LANES lanes and refuses one
    more before the device branch, on the CPU as on the card."""
    w = edge_cases.usage_case("limit")
    used, packed, req_f = (torch.from_numpy(x) for x in operands(w))
    got = tk.sharded_usage(used, packed, req_f, 2, w["row_offset"])
    assert got.shape == used.shape
    more = torch.cat([packed, packed[:2]])
    more_f = torch.cat([req_f, req_f[:2]])
    with pytest.raises(ValueError, match="at most 65536"):
        tk.sharded_usage(used, more, more_f, 2, w["row_offset"])
