// Per-node score pieces, shared by score_batch.cu and fused_place.cu.
//
// One node's column of nomad_tpu/ops/kernels.py:score_nodes (:525):
// feasibility (eligibility, datacenter, constraints, devices, ports, class
// eligibility, host mask), the distinct_hosts gate, fit and binpack
// (fit_and_binpack, :308), preemption assist (preemption_state, :462),
// anti-affinity (:336), penalty (:346), affinity (:351), spread (:377) and
// the mean of the appended components (:565).
//
// The work is split by what it depends on:
// * lane_setup digests one lane's packed request once: the active
//   constraint, device and port slots in order, the positive datacenter
//   hashes, each predicate's op decoded (pred_flags), the affinity weight
//   sum.  The per-node loops then run over what the lane uses.
// * spread_stanza_score is the spread term of one stanza for one node
//   value (the 16-entry value-table loop).  A node's spread term depends on
//   the node only through its value, so a lane evaluates it once per
//   value-table entry, plus once for a value the table lacks and once for
//   no value (SPR_ENTRIES); duplicate hashes in a table give every copy the
//   in-order sums of all of them, as the loop does for a node.
// * feasible_k (feasibility of K nodes together), fit_parts, anti_affinity
//   and affinity are the rest for one node; partial_sum and score_of
//   combine the components into the final score in the plain version's
//   order.
//
// Loop widths are compile-time bounds (Widths, the wrapper picks the
// instantiation from the batch's Features); the batch's own widths bound
// the loops at run time below them, so any instantiation at least as wide
// gives the same result.  Node columns come through a source type: the
// matrix in device memory (GlobalNodes) or a tile staged in shared memory
// (score_batch.cu StagedNodes).
//
// Numerics: every float operation is written in the order the plain
// PyTorch version (ops/kernels.py) performs it; with -fmad=false and no
// fast math the kernels that include this file round exactly as it does.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "feasibility.cuh"
#include "layout.cuh"

#define NEG_INF_F (-1e30f)
#define LOG2_10_F 3.32192802429199219f   // float32(3.321928094887362)
#define INV_18_F 0.0555555559694767f     // float32(1/18)
#define PREEMPTION_RATE_F 0.0048f
#define PREEMPTION_ORIGIN_F 2048.0f

// A stanza's spread score by the node's value: value-table entry v < MAX_V
// (the first entry holding the node's hash), a value the table lacks, or
// no value (hash 0).
#define SPR_NOMATCH MAX_V
#define SPR_NOVALUE (MAX_V + 1)
#define SPR_ENTRIES (MAX_V + 2)

// Compile-time loop widths of one instantiation.
template <int CW_, int AW_, int SW_, bool PRE_, bool PORTS_>
struct Widths {
  static constexpr int CW = CW_;        // constraint slots
  static constexpr int AW = AW_;        // affinity slots
  static constexpr int SW = SW_;        // spread stanzas
  static constexpr bool PRE = PRE_;     // preemption assist
  static constexpr bool PORTS = PORTS_; // static and dynamic ports
};

// The instantiations every kernel that scores carries: the bench's eight
// job shapes, and every width.
typedef Widths<2, 1, 1, false, false> WidthsBench;
typedef Widths<MAX_C, MAX_A, MAX_S, true, true> WidthsFull;

// The batch's own widths (ops/kernels.py Features), at run time.
struct RunWidths {
  int c_width, a_width, s_width, preempt, ports;
};

// Which instantiation covers `r`: 0 bench, 1 full.
__host__ __forceinline__ int widths_tier(const RunWidths& r) {
  return r.c_width <= WidthsBench::CW && r.a_width <= WidthsBench::AW &&
                 r.s_width <= WidthsBench::SW && !r.preempt && !r.ports
             ? 0
             : 1;
}

// One predicate of a lane: the attribute slot (clamped to the table) and
// where its columns are (a staged column index, or -1: the matrix).
struct Pred {
  int slot;
  int hcol;   // attr_hash column
  int vcol;   // attr_num or attr_ver column (PF_VER), read where PF_NUM
  int flags;  // pred_flags(op)
  int hash;
  float num;
};

template <int N>
struct AtLeast1 {
  static constexpr int value = N > 0 ? N : 1;
};

// One lane's request, digested for the per-node loops.
template <class W>
struct LaneSetup {
  float ask0, ask1, ask2;
  float desired;   // desired_count
  float aff_wsum;  // affinity_weight_sum
  int algorithm;
  int distinct;    // distinct_hosts
  int dc_on;       // the datacenter list applies (dc_hash[0] != -1)
  int dc_col;      // staged column of slot 0's hash, or -1
  int n_dc;        // positive datacenter hashes
  int dc[MAX_DC];
  int n_c;         // active constraints, in slot order
  Pred c[AtLeast1<W::CW>::value];
  int n_a;         // a_width: every affinity slot, active or not
  Pred a[AtLeast1<W::AW>::value];
  float a_w[AtLeast1<W::AW>::value];
  int n_dev;       // device slots with a non-zero ask
  int dev_slot[DEV_SLOTS];
  int dev_want[DEV_SLOTS];
  int ports_on;
  int n_port;      // static ports asked
  int port[MAX_PORTS];
  int p_dyn;
  int preempt_on;
  int pbucket;     // preempt_bucket
  int kb;          // buckets below it, clamped to [0, PRIO_BUCKETS]
  int has_spread;  // any active stanza below s_width
  int s_on[AtLeast1<W::SW>::value];
  int s_slot[AtLeast1<W::SW>::value];
  int s_col[AtLeast1<W::SW>::value];
};

// Σ|w| over the active affinity slots, in slot order.
__device__ __forceinline__ float affinity_weight_sum(const int* ri,
                                                     const float* rf,
                                                     int a_width) {
  float s = 0.0f;
  for (int j = 0; j < a_width; ++j) {
    const float wgt = rf[RF_A_WEIGHT + j];
    s = s + fabsf(wgt) * (ri[RI_A_SLOT + j] >= 0 ? 1.0f : 0.0f);
  }
  return s;
}

__device__ __forceinline__ Pred make_pred(int slot, int op, int hash,
                                          float num, int a) {
  Pred p;
  p.slot = slot >= a ? a - 1 : slot;  // gathers clamp, as in JAX
  p.hcol = -1;
  p.vcol = -1;
  p.flags = pred_flags(op);
  p.hash = hash;
  p.num = num;
  return p;
}

// Digest one lane's packed request (one thread).  `a` is the matrix's
// attribute slot count.
template <class W>
__device__ void lane_setup(LaneSetup<W>& L, const int* ri, const float* rf,
                           const RunWidths& r, int a) {
  L.ask0 = rf[RF_ASK];
  L.ask1 = rf[RF_ASK + 1];
  L.ask2 = rf[RF_ASK + 2];
  L.desired = rf[RF_DESIRED_COUNT];
  L.algorithm = ri[RI_ALGORITHM];
  L.distinct = ri[RI_DISTINCT_HOSTS] != 0;
  L.dc_on = ri[RI_DC_HASH] != -1;
  L.dc_col = -1;
  L.n_dc = 0;
  for (int j = 0; j < MAX_DC; ++j)
    if (ri[RI_DC_HASH + j] > 0) L.dc[L.n_dc++] = ri[RI_DC_HASH + j];
  L.n_c = 0;
  for (int c = 0; c < r.c_width && c < W::CW; ++c)
    if (ri[RI_C_SLOT + c] >= 0)
      L.c[L.n_c++] = make_pred(ri[RI_C_SLOT + c], ri[RI_C_OP + c],
                               ri[RI_C_HASH + c], rf[RF_C_NUM + c], a);
  L.n_a = 0;
  for (int j = 0; j < r.a_width && j < W::AW; ++j) {
    L.a[L.n_a] = make_pred(ri[RI_A_SLOT + j], ri[RI_A_OP + j],
                           ri[RI_A_HASH + j], rf[RF_A_NUM + j], a);
    L.a_w[L.n_a++] = rf[RF_A_WEIGHT + j];
  }
  L.aff_wsum = affinity_weight_sum(ri, rf, L.n_a);
  L.n_dev = 0;
  for (int j = 0; j < DEV_SLOTS; ++j)
    if (ri[RI_DEV_ASK + j] != 0) {
      L.dev_slot[L.n_dev] = j;
      L.dev_want[L.n_dev++] = ri[RI_DEV_ASK + j];
    }
  L.ports_on = W::PORTS && r.ports;
  L.n_port = 0;
  for (int j = 0; j < MAX_PORTS; ++j)
    if (ri[RI_P_STATIC + j] >= 0) L.port[L.n_port++] = ri[RI_P_STATIC + j];
  L.p_dyn = ri[RI_P_DYN];
  L.preempt_on = W::PRE && r.preempt;
  L.pbucket = ri[RI_PREEMPT_BUCKET];
  L.kb = L.pbucket < 0 ? 0
         : (L.pbucket > PRIO_BUCKETS ? PRIO_BUCKETS : L.pbucket);
  L.has_spread = 0;
  for (int s = 0; s < AtLeast1<W::SW>::value; ++s) {
    const int slot = (s < r.s_width && s < W::SW) ? ri[RI_S_SLOT + s] : -1;
    L.s_on[s] = slot >= 0;
    L.s_slot[s] = slot >= a ? a - 1 : slot;
    L.s_col[s] = -1;
    L.has_spread |= slot >= 0;
  }
}

// Min, max and presence of the used values of each stanza's table
// (spread_score's even mode).
__device__ __forceinline__ void even_spread_stats(const int* s_hash,
                                                  const float* s_cnt,
                                                  float* s_mn, float* s_mx,
                                                  int* s_any) {
  for (int s = 0; s < MAX_S; ++s) {
    float mn = 1e30f, mx = -1e30f;
    int any = 0;
    for (int v = 0; v < MAX_V; ++v) {
      const float c = s_cnt[s * MAX_V + v];
      if (s_hash[s * MAX_V + v] != 0 && c > 0.0f) {
        any = 1;
        mn = fminf(mn, c);
        mx = fmaxf(mx, c);
      }
    }
    s_mn[s] = mn;
    s_mx[s] = mx;
    s_any[s] = any;
  }
}

// Stanza s's spread score for a node whose value hash is `nvalue`
// (kernels.py:377): the value table's counts and targets summed in entry
// order.  `nomatch` stands for a non-zero value no entry holds.
__device__ __forceinline__ float spread_stanza_score(
    int nvalue, bool nomatch, int s, const int* ri, const float* rf,
    const int* s_hash, const float* s_cnt, float mn, float mx, int any) {
  float count_at = 0.0f, desired_at = 0.0f;
  bool has_target = false;
  for (int v = 0; v < MAX_V; ++v) {
    const int vh = s_hash[s * MAX_V + v];
    const bool vm = !nomatch && nvalue == vh && vh != 0;
    count_at = count_at + (vm ? s_cnt[s * MAX_V + v] : 0.0f);
    const float des = rf[RF_S_DESIRED + s * MAX_V + v];
    const bool ok = vm && !isnan(des);
    has_target |= ok;
    desired_at = desired_at + (ok ? des : 0.0f);
  }
  if (ri[RI_S_EVEN + s] != 0) {
    float eb;
    if (count_at != mn) {
      eb = mn == 0.0f ? -1.0f : (mn - count_at) / fmaxf(mn, 1e-9f);
    } else {
      eb = mn == mx ? -1.0f
                    : (mn == 0.0f ? 1.0f : (mx - mn) / fmaxf(mn, 1e-9f));
    }
    if (!any) eb = 0.0f;
    return nvalue != 0 ? eb : -1.0f;
  }
  float desired_v = has_target ? desired_at : CUDART_NAN_F;
  const float implicit = rf[RF_S_IMPLICIT + s];
  if (!has_target && !isnan(implicit)) desired_v = implicit;
  if (isnan(desired_v)) return -1.0f;
  const float rel = rf[RF_S_WEIGHT + s] / fmaxf(rf[RF_S_SUM_WEIGHTS], 1e-9f);
  return ((desired_v - (count_at + 1.0f)) / fmaxf(desired_v, 1e-9f)) * rel;
}

// Entry e of stanza s's score table (SPR_* above).
__device__ __forceinline__ float spread_entry_score(
    int e, int s, const int* ri, const float* rf, const int* s_hash,
    const float* s_cnt, const float* s_mn, const float* s_mx,
    const int* s_any) {
  const int nvalue = e < MAX_V ? s_hash[s * MAX_V + e]
                     : (e == SPR_NOMATCH ? 1 : 0);
  return spread_stanza_score(nvalue, e == SPR_NOMATCH, s, ri, rf, s_hash,
                             s_cnt, s_mn[s], s_mx[s], s_any[s]);
}

// The entry of a node value in stanza s's table: the first entry that
// holds it, or SPR_NOMATCH / SPR_NOVALUE.
__device__ __forceinline__ int spread_entry_of(int nvalue, int s,
                                               const int* s_hash) {
  if (nvalue == 0) return SPR_NOVALUE;
  for (int v = 0; v < MAX_V; ++v)
    if (s_hash[s * MAX_V + v] == nvalue) return v;
  return SPR_NOMATCH;
}

// Node columns straight from the matrix in device memory.  `m` points
// into the kernel's __grid_constant__ parameters (no local copy).
struct GlobalNodes {
  const NodeTables* m;
  const float* totals;
  __device__ __forceinline__ bool elig(int, int i) const {
    return m->eligible[i] != 0;
  }
  __device__ __forceinline__ int cls(int, int i) const {
    return m->class_id[i];
  }
  __device__ __forceinline__ int hash(int, int i, int, int slot) const {
    return m->attr_hash[(size_t)i * m->a + slot];
  }
  __device__ __forceinline__ float val(int, int i, int, int slot,
                                       bool ver) const {
    return (ver ? m->attr_ver : m->attr_num)[(size_t)i * m->a + slot];
  }
  __device__ __forceinline__ void tot(int, int i, float& t0, float& t1,
                                      float& t2) const {
    t0 = totals[i * 3];
    t1 = totals[i * 3 + 1];
    t2 = totals[i * 3 + 2];
  }
};

template <class Src>
__device__ __forceinline__ bool pred_on(const Src& S, int p, int i,
                                        const Pred& pr) {
  const int h = S.hash(p, i, pr.hcol, pr.slot);
  const float v = (pr.flags & PF_NUM)
                      ? S.val(p, i, pr.vcol, pr.slot, (pr.flags & PF_VER) != 0)
                      : 0.0f;
  return pred_holds(h, v, pr.flags, pr.hash, pr.num);
}

// Feasibility of K nodes (rows i[j], positions p[j] in the source) before
// the distinct_hosts gate: eligible, datacenter, constraints, devices,
// ports, class eligibility (a class id past class_elig's end reads its last
// entry, as JAX's out-of-bounds gather does) and the host mask.  Each
// check runs over the K nodes together: a predicate's fields are read once
// for all of them and their loads are independent.
template <class W, int K, class Src>
__device__ __forceinline__ void feasible_k(const Src& S, const int* p,
                                           const int* i, const LaneSetup<W>& L,
                                           const uint8_t* class_elig, int k,
                                           const bool* host, bool* feas,
                                           bool* elig) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    elig[j] = S.elig(p[j], i[j]);
    feas[j] = elig[j] && host[j];
  }
  if (L.dc_on) {
    int dc[MAX_DC];
#pragma unroll
    for (int d = 0; d < MAX_DC; ++d) dc[d] = L.dc[d];
    const int n_dc = L.n_dc, col = L.dc_col;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!feas[j]) continue;
      const int h = S.hash(p[j], i[j], col, 0);
      bool member = false;
#pragma unroll
      for (int d = 0; d < MAX_DC; ++d) member |= d < n_dc && h == dc[d];
      feas[j] = member;
    }
  }
#pragma unroll
  for (int c = 0; c < W::CW; ++c) {
    if (c >= L.n_c) break;
    const Pred pr = L.c[c];
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (feas[j]) feas[j] = pred_on(S, p[j], i[j], pr);
  }
  for (int d = 0; d < L.n_dev; ++d) {
    const int slot = L.dev_slot[d], want = L.dev_want[d];
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (feas[j])
        feas[j] = S.m->dev_total[(size_t)i[j] * DEV_SLOTS + slot] -
                      S.m->dev_used[(size_t)i[j] * DEV_SLOTS + slot] >=
                  want;
  }
  if (W::PORTS && L.ports_on) {
    for (int d = 0; d < L.n_port; ++d) {
      const int port = L.port[d];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (!feas[j]) continue;
        // Shift the u32 bits, never the signed int32 view.
        const unsigned word =
            (unsigned)S.m->port_words[(size_t)i[j] * S.m->w + (port >> 5)];
        feas[j] = ((word >> (port & 31)) & 1u) == 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
      feas[j] = feas[j] && (S.m->dyn_used[i[j]] + L.p_dyn <= DYN_PORT_CAPACITY);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (!feas[j]) continue;
    const int cid = S.cls(p[j], i[j]);
    feas[j] = cid >= 0 && class_elig[cid >= k ? k - 1 : cid] != 0;
  }
}

// Fit, binpack and preemption of a lane on one node whose usage is
// (u0, u1, u2) and totals (t0, t1, t2) (fit_and_binpack, kernels.py:308;
// preemption_state, :462).
struct FitParts {
  float binpack;
  float pre;       // pre_component: 0 unless needs_pre
  bool fits_all;   // fits, or fits once lower-priority work is evicted
  bool needs_pre;
};

template <class W>
__device__ __forceinline__ FitParts fit_parts(const LaneSetup<W>& L,
                                              const float* prio_used, int i,
                                              float u0, float u1, float u2,
                                              float t0, float t1, float t2) {
  FitParts r;
  const float ut0 = u0 + L.ask0, ut1 = u1 + L.ask1, ut2 = u2 + L.ask2;
  const bool fits = ut0 <= t0 && ut1 <= t1 && ut2 <= t2;
  const float free0 = 1.0f - ut0 / fmaxf(t0, 1.0f);
  const float free1 = 1.0f - ut1 / fmaxf(t1, 1.0f);
  const float total10 = exp2f(free0 * LOG2_10_F) + exp2f(free1 * LOG2_10_F);
  const float bp = fminf(fmaxf(20.0f - total10, 0.0f), 18.0f);
  const float sp = fminf(fmaxf(total10 - 2.0f, 0.0f), 18.0f);
  r.binpack = (L.algorithm == 1 ? sp : bp) * INV_18_F;
  r.needs_pre = false;
  r.pre = 0.0f;
  // Only a node that does not fit can need preemption, and only for a
  // lane with a bucket (usable needs preempt_bucket >= 0).
  if (W::PRE && L.preempt_on && !fits && L.pbucket >= 0) {
    float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f, mid_max = 0.0f, mid_sum = 0.0f;
    const float* pu = prio_used + (size_t)i * PRIO_BUCKETS * 3;
    for (int bk = 0; bk < L.kb; ++bk) {
      const float q0 = pu[bk * 3], q1 = pu[bk * 3 + 1], q2 = pu[bk * 3 + 2];
      f0 = f0 + q0;
      f1 = f1 + q1;
      f2 = f2 + q2;
      const bool present = q0 > 0.0f || q1 > 0.0f || q2 > 0.0f;
      const float mid =
          present ? ((float)bk + 0.5f) * (101.0f / PRIO_BUCKETS) : 0.0f;
      mid_max = fmaxf(mid_max, mid);
      mid_sum = mid_sum + mid;
    }
    const bool usable = f0 > 0.0f || f1 > 0.0f || f2 > 0.0f;
    const bool fwp = (ut0 - f0 <= t0) && (ut1 - f1 <= t1) && (ut2 - f2 <= t2);
    r.needs_pre = fwp && usable;
    if (r.needs_pre) {
      const float net =
          mid_max > 0.0f ? mid_max + mid_sum / fmaxf(mid_max, 1e-9f) : 0.0f;
      r.pre =
          1.0f / (1.0f + expf(PREEMPTION_RATE_F * (net - PREEMPTION_ORIGIN_F)));
    }
  }
  r.fits_all = fits || r.needs_pre;
  return r;
}

// Anti-affinity of `tg` proposed allocs of the job's group on the node.
__device__ __forceinline__ float anti_affinity(int tg, float desired,
                                               bool& app) {
  const float coll = (float)tg;
  app = coll > 0.0f;
  return app ? -(coll + 1.0f) / desired : 0.0f;
}

// Affinity of a lane on node i (kernels.py:351): Σ match·weight in slot
// order over every a_width slot, then over Σ|weight|.
template <class W, class Src>
__device__ __forceinline__ float affinity(const Src& S, int p, int i,
                                          const LaneSetup<W>& L, bool& app) {
  float aff_total = 0.0f;
#pragma unroll
  for (int j = 0; j < W::AW; ++j) {
    if (j < L.n_a) {
      const bool m = L.a[j].slot >= 0 && pred_on(S, p, i, L.a[j]);
      aff_total = aff_total + (m ? 1.0f : 0.0f) * L.a_w[j];
    }
  }
  app = L.n_a > 0 && aff_total != 0.0f && L.aff_wsum > 0.0f;
  return app ? aff_total / fmaxf(L.aff_wsum, 1e-9f) : 0.0f;
}

// The sum of the components before spread, in the plain version's order:
// ((binpack + anti-affinity) + penalty) + affinity.
__device__ __forceinline__ float partial_sum(float binpack, float aa,
                                             float pen, float aff) {
  return ((binpack + aa) + pen) + aff;
}

// The final score of a feasible, fitting node: (partial + spread) +
// preemption over the count of appended components (an exact small
// integer, so its order of sums does not matter).
__device__ __forceinline__ float score_of(float partial, float spr_total,
                                          bool has_spread, float pre,
                                          int n_appended) {
  const bool spr_app = has_spread && spr_total != 0.0f;
  const float spr = spr_app ? spr_total : 0.0f;
  const float total = (partial + spr) + pre;
  const float count = (float)(1 + n_appended + (spr_app ? 1 : 0));
  return total / count;
}

struct Best {
  float val;
  int row;
  float bin;
  int pre;
};

// Highest score, lowest row on ties (jnp.argmax).
__device__ __forceinline__ bool better(float v, int r, float bv, int br) {
  return v > bv || (v == bv && r < br);
}

// Reduce (best, three counters) over a warp; lane 0 holds the result.
__device__ __forceinline__ void warp_best(Best& best, int& c0, int& c1,
                                          int& c2) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best.val, off);
    const int orow = __shfl_down_sync(0xffffffffu, best.row, off);
    const float ob = __shfl_down_sync(0xffffffffu, best.bin, off);
    const int op = __shfl_down_sync(0xffffffffu, best.pre, off);
    if (better(ov, orow, best.val, best.row)) {
      best.val = ov;
      best.row = orow;
      best.bin = ob;
      best.pre = op;
    }
  }
  c0 = __reduce_add_sync(0xffffffffu, c0);
  c1 = __reduce_add_sync(0xffffffffu, c1);
  c2 = __reduce_add_sync(0xffffffffu, c2);
}

// cp.async of one 4-byte word into shared memory.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}
