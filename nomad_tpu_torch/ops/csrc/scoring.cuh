// Per-node score and the block argmax, shared by fused_place.cu and
// score_batch.cu.
//
// score_node is one node's column of nomad_tpu/ops/kernels.py:score_nodes
// (:525): feasibility (feasibility.cuh), the distinct_hosts gate, fit and
// binpack (fit_and_binpack, :308), preemption assist (preemption_state,
// :462), anti-affinity (:336), penalty (:346), affinity (:351), spread
// (:377) and the mean of the appended components (:565).  The lane's
// packed request and spread tables are read from shared memory; the usage
// row, tg_count and penalty bit come from the caller, because fused_place
// carries them across its scan and score_batch reads them as given.
//
// even_spread_stats is the per-stanza min/max over a lane's value table
// (spread_score's even mode), and block_argmax the (score, row) reduction:
// highest score, lowest row on ties, as jnp.argmax does, with the three
// node counters summed alongside.
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

// One lane's request and spread state, as score_node reads it.
struct LaneView {
  const int* ri;             // packed request, REQ_INT_WIDTH
  const float* rf;           // packed request, REQ_FLOAT_WIDTH
  const int* s_hash;         // (MAX_S, MAX_V) known spread values
  const float* s_cnt;        // (MAX_S, MAX_V) usage count per value
  const float* s_mn;         // (MAX_S) even-spread statistics
  const float* s_mx;
  const int* s_any;
  const uint8_t* class_elig; // (k,)
  int k;
  const uint8_t* host_mask;  // (N,)
  float aff_wsum;            // affinity_weight_sum
  bool has_spread;           // any_spread
  int c_width, a_width, s_width;
  bool preempt, ports;
};

struct NodeScore {
  float fin;      // final score; NEG_INF_F where infeasible or not fitting
  float binpack;  // the binpack component
  bool needs_pre; // fits only after preemption
  bool feas;      // feasible, distinct_hosts included
  bool elig;      // the node's eligible bit
  bool fits_all;  // fits, with preemption assist
};

struct Best {
  float val;
  int row;
  float bin;
  int pre;
};

__device__ __forceinline__ bool better(float v, int r, float bv, int br) {
  return v > bv || (v == bv && r < br);
}

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

__device__ __forceinline__ bool any_spread(const int* ri, int s_width) {
  bool any = false;
  for (int s = 0; s < s_width; ++s) any |= ri[RI_S_SLOT + s] >= 0;
  return any;
}

// Min, max and presence of the used values of each stanza's table.
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

// Node i of one lane: u is the (N, 3) usage the lane sees, tg its proposed
// allocs of this job and task group on the node, pen_app its penalty bit.
__device__ __forceinline__ NodeScore score_node(const NodeTables& M,
                                                const float* totals,
                                                const float* prio_used,
                                                const float* u, int i, int tg,
                                                bool pen_app,
                                                const LaneView& L) {
  const int* ri = L.ri;
  const float* rf = L.rf;
  NodeScore r;

  // ---- feasibility (feasibility_mask, kernels.py:265; feasibility.cuh)
  bool elig;
  bool feas = node_feasible(M, i, ri, rf, L.c_width, L.ports, L.class_elig,
                            L.k, L.host_mask, elig);
  feas = feas && !(ri[RI_DISTINCT_HOSTS] != 0 && tg > 0);

  // ---- fit and binpack (fit_and_binpack, kernels.py:308)
  const float ask0 = rf[RF_ASK], ask1 = rf[RF_ASK + 1], ask2 = rf[RF_ASK + 2];
  const float t0 = totals[i * 3], t1 = totals[i * 3 + 1],
              t2 = totals[i * 3 + 2];
  const float ut0 = u[i * 3] + ask0, ut1 = u[i * 3 + 1] + ask1,
              ut2 = u[i * 3 + 2] + ask2;
  const bool fits = ut0 <= t0 && ut1 <= t1 && ut2 <= t2;
  const float free0 = 1.0f - ut0 / fmaxf(t0, 1.0f);
  const float free1 = 1.0f - ut1 / fmaxf(t1, 1.0f);
  const float total10 = exp2f(free0 * LOG2_10_F) + exp2f(free1 * LOG2_10_F);
  const float bp = fminf(fmaxf(20.0f - total10, 0.0f), 18.0f);
  const float sp = fminf(fmaxf(total10 - 2.0f, 0.0f), 18.0f);
  const float binpack = (ri[RI_ALGORITHM] == 1 ? sp : bp) * INV_18_F;

  // ---- preemption assist (preemption_state, kernels.py:462)
  bool needs_pre = false;
  float pre_component = 0.0f;
  if (L.preempt) {
    const int pbucket = ri[RI_PREEMPT_BUCKET];
    const int kb =
        pbucket < 0 ? 0 : (pbucket > PRIO_BUCKETS ? PRIO_BUCKETS : pbucket);
    float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f, mid_max = 0.0f, mid_sum = 0.0f;
    const float* pu = prio_used + (size_t)i * PRIO_BUCKETS * 3;
    for (int bk = 0; bk < kb; ++bk) {
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
    const bool usable = pbucket >= 0 && (f0 > 0.0f || f1 > 0.0f || f2 > 0.0f);
    const bool fwp = (ut0 - f0 <= t0) && (ut1 - f1 <= t1) && (ut2 - f2 <= t2);
    needs_pre = !fits && fwp && usable;
    if (needs_pre) {
      const float net =
          mid_max > 0.0f ? mid_max + mid_sum / fmaxf(mid_max, 1e-9f) : 0.0f;
      pre_component =
          1.0f / (1.0f + expf(PREEMPTION_RATE_F * (net - PREEMPTION_ORIGIN_F)));
    }
  }
  const bool fits_all = fits || needs_pre;

  // ---- anti-affinity and penalty (kernels.py:336, :346)
  const float coll = (float)tg;
  const bool aa_app = coll > 0.0f;
  const float aa = aa_app ? -(coll + 1.0f) / rf[RF_DESIRED_COUNT] : 0.0f;
  const float pen = pen_app ? -1.0f : 0.0f;

  // ---- affinity (kernels.py:351)
  float aff_total = 0.0f;
  for (int j = 0; j < L.a_width; ++j) {
    const int slot = ri[RI_A_SLOT + j];
    const bool m = slot >= 0 &&
                   check_predicate(M, i, slot, ri[RI_A_OP + j],
                                   ri[RI_A_HASH + j], rf[RF_A_NUM + j]);
    aff_total = aff_total + (m ? 1.0f : 0.0f) * rf[RF_A_WEIGHT + j];
  }
  const bool aff_app =
      L.a_width > 0 && aff_total != 0.0f && L.aff_wsum > 0.0f;
  const float aff = aff_app ? aff_total / fmaxf(L.aff_wsum, 1e-9f) : 0.0f;

  // ---- spread (kernels.py:377)
  float spr_total = 0.0f;
  for (int s = 0; s < L.s_width; ++s) {
    int slot = ri[RI_S_SLOT + s];
    if (slot < 0) continue;
    if (slot >= M.a) slot = M.a - 1;
    const int nvalue = M.attr_hash[(size_t)i * M.a + slot];
    float count_at = 0.0f, desired_at = 0.0f;
    bool has_target = false;
    for (int v = 0; v < MAX_V; ++v) {
      const int vh = L.s_hash[s * MAX_V + v];
      const bool vm = nvalue == vh && vh != 0;
      count_at = count_at + (vm ? L.s_cnt[s * MAX_V + v] : 0.0f);
      const float des = rf[RF_S_DESIRED + s * MAX_V + v];
      const bool ok = vm && !isnan(des);
      has_target |= ok;
      desired_at = desired_at + (ok ? des : 0.0f);
    }
    float score;
    if (ri[RI_S_EVEN + s] != 0) {
      const float mn = L.s_mn[s], mx = L.s_mx[s];
      float eb;
      if (count_at != mn) {
        eb = mn == 0.0f ? -1.0f : (mn - count_at) / fmaxf(mn, 1e-9f);
      } else {
        eb = mn == mx ? -1.0f
                      : (mn == 0.0f ? 1.0f : (mx - mn) / fmaxf(mn, 1e-9f));
      }
      if (!L.s_any[s]) eb = 0.0f;
      score = nvalue != 0 ? eb : -1.0f;
    } else {
      float desired_v = has_target ? desired_at : CUDART_NAN_F;
      const float implicit = rf[RF_S_IMPLICIT + s];
      if (!has_target && !isnan(implicit)) desired_v = implicit;
      if (isnan(desired_v)) {
        score = -1.0f;
      } else {
        const float rel =
            rf[RF_S_WEIGHT + s] / fmaxf(rf[RF_S_SUM_WEIGHTS], 1e-9f);
        score =
            ((desired_v - (count_at + 1.0f)) / fmaxf(desired_v, 1e-9f)) * rel;
      }
    }
    spr_total = spr_total + score;
  }
  const bool spr_app = L.has_spread && spr_total != 0.0f;
  const float spr = spr_app ? spr_total : 0.0f;

  // ---- mean of the appended components (score_nodes, kernels.py:565)
  const float total = binpack + aa + pen + aff + spr + pre_component;
  const float count = 1.0f + (aa_app ? 1.0f : 0.0f) + (pen_app ? 1.0f : 0.0f) +
                      (aff_app ? 1.0f : 0.0f) + (spr_app ? 1.0f : 0.0f) +
                      (needs_pre ? 1.0f : 0.0f);
  r.fin = (feas && fits_all) ? total / count : NEG_INF_F;
  r.binpack = binpack;
  r.needs_pre = needs_pre;
  r.feas = feas;
  r.elig = elig;
  r.fits_all = fits_all;
  return r;
}

// Reduce every thread's best (score, row) and its three counters over the
// block: warp shuffles, then thread 0 over the warps' results.  The result
// is valid in thread 0 only.  w_best and w_cnt are shared memory of one
// entry per warp; every thread of the block must call this.
template <int WARPS>
__device__ __forceinline__ void block_argmax(Best& best, int& c0, int& c1,
                                             int& c2, Best* w_best,
                                             int (*w_cnt)[3]) {
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
    c0 += __shfl_down_sync(0xffffffffu, c0, off);
    c1 += __shfl_down_sync(0xffffffffu, c1, off);
    c2 += __shfl_down_sync(0xffffffffu, c2, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    w_best[warp] = best;
    w_cnt[warp][0] = c0;
    w_cnt[warp][1] = c1;
    w_cnt[warp][2] = c2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    best = w_best[0];
    c0 = w_cnt[0][0];
    c1 = w_cnt[0][1];
    c2 = w_cnt[0][2];
    for (int wi = 1; wi < WARPS; ++wi) {
      const Best o = w_best[wi];
      if (better(o.val, o.row, best.val, best.row)) best = o;
      c0 += w_cnt[wi][0];
      c1 += w_cnt[wi][1];
      c2 += w_cnt[wi][2];
    }
  }
}

// One packed result row (PACKED_* columns): the pick, or row -1 and zero
// score, binpack and preemption when nothing fits; the counters always.
// Returns whether the pick is real.
__device__ __forceinline__ bool write_packed(float* o, const Best& b, int ce,
                                             int cf, int cx) {
  const bool ok = b.val > NEG_INF_F / 2.0f;
  o[0] = ok ? (float)b.row : -1.0f;
  o[1] = ok ? b.val : 0.0f;
  o[2] = ok ? b.bin : 0.0f;
  o[3] = (ok && b.pre) ? 1.0f : 0.0f;
  o[4] = (float)ce;
  o[5] = (float)cf;
  o[6] = (float)cx;
  return ok;
}
