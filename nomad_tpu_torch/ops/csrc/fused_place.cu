// fused_place — B placement scans in one launch.
//
// Replaces the per-lane part of the JAX megakernel
// nomad_tpu/ops/kernels.py:_fused_place_batch_impl (the vmapped
// _place_scan over score_nodes, kernels.py:521 and :707), and, at B=1 with
// a dense base usage and no lane deltas, place_task_group (kernels.py:774).
// The cross-lane AllocsFit verify column is allocs_fit_verify.cu.
//
// Design: one thread block per eval lane, the whole P-step scan inside the
// block.  Each step every thread scores its strided share of the N nodes
// with the full score_nodes semantics (datacenter, constraint predicates,
// devices, ports, class eligibility, host mask, distinct_hosts, fit and
// binpack, preemption assist, anti-affinity, penalty, affinity, spread),
// keeps its best (score, row) and three counters, and a block reduction
// (warp shuffles, then shared memory) picks the winner: highest score,
// lowest row on ties, as jnp.argmax does.  Thread 0 then applies the
// carry: the ask into the lane's usage at the winning row, the tg_count
// bump, and the spread value table and counts, which live in shared memory
// (apply_spread_values, kernels.py:677).
//
// Storage: the lane's usage is a dense (N, 3) scratch in device memory
// (7.9 MB at B=64, N=10240), initialised from the shared `used` plus the
// lane's <= D deltas (duplicates summed in delta order, as .at[].add does).
// tg_count bumps are a sparse overlay: the rows this lane placed so far,
// kept in shared memory.
//
// What bounds it on an H100: neither the bytes nor the arithmetic at the
// main path's shape.  Each step re-reads the lane's node rows (about
// 0.3 KB a node with 16 constraint slots live) from L2, and the block-wide
// reduction serialises every step, so the scan is latency-bound: B blocks
// on 132 SMs, P dependent steps each.  The step-invariant terms
// (feasibility, penalty, affinity, preemption state) are recomputed every
// step; hoisting them, staging node rows with cp.async/TMA and splitting a
// lane over several blocks are later work.
//
// Numerics: built without --use_fast_math and with -fmad=false, so exp2f,
// expf and division are the IEEE/libdevice versions and no a*b+c is fused:
// the kernel rounds like the plain PyTorch version on the card.  x/18 is
// computed as x * float(1/18), as XLA and the plain version do.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "feasibility.cuh"
#include "layout.cuh"

#define THREADS 512
#define WARPS (THREADS / 32)
#define MAX_PLACEMENTS 64

#define NEG_INF_F (-1e30f)
#define LOG2_10_F 3.32192802429199219f   // float32(3.321928094887362)
#define INV_18_F 0.0555555559694767f     // float32(1/18)
#define PREEMPTION_RATE_F 0.0048f
#define PREEMPTION_ORIGIN_F 2048.0f

struct FusedParams {
  // matrix (N rows)
  NodeTables m;              // the columns feasibility reads
  const float* totals;       // (N, 3)
  const float* used;         // (N, 3)
  const float* prio_used;    // (N, PRIO_BUCKETS, 3)
  // lanes
  const int32_t* delta_rows;   // (B, D)
  const float* delta_vals;     // (B, D, 3)
  const int32_t* tg_counts;    // (B, N)
  const float* spread_counts;  // (B, MAX_S, MAX_V)
  const uint8_t* penalties;    // (B, N)
  const int32_t* req_i;        // (B, REQ_INT_WIDTH)
  const float* req_f;          // (B, REQ_FLOAT_WIDTH)
  const uint8_t* class_eligs;  // (B, K)
  const uint8_t* host_masks;   // (B, N)
  const uint8_t* lane_mask;    // (B,)
  float* out;                  // (B, P, PACKED_WIDTH)
  float* scratch;              // (B, N, 3) per-lane usage
  int n, b, d, k, p;
  int c_width, a_width, s_width, preempt, ports;
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

__global__ void __launch_bounds__(THREADS)
fused_place_kernel(FusedParams P) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = P.n;
  float* out = P.out + (size_t)lane * P.p * PACKED_WIDTH;

  if (!P.lane_mask[lane]) {  // dead lane: row -1, zeros
    for (int i = tid; i < P.p * PACKED_WIDTH; i += THREADS)
      out[i] = (i % PACKED_WIDTH == 0) ? -1.0f : 0.0f;
    return;
  }

  __shared__ int ri[REQ_INT_WIDTH];
  __shared__ float rf[REQ_FLOAT_WIDTH];
  __shared__ int s_hash[MAX_S * MAX_V];
  __shared__ float s_cnt[MAX_S * MAX_V];
  __shared__ float s_mn[MAX_S], s_mx[MAX_S];
  __shared__ int s_any[MAX_S];
  __shared__ int placed[MAX_PLACEMENTS];
  __shared__ int n_placed;
  __shared__ int done;
  __shared__ Best w_best[WARPS];
  __shared__ int w_cnt[WARPS][3];

  for (int i = tid; i < REQ_INT_WIDTH; i += THREADS)
    ri[i] = P.req_i[(size_t)lane * REQ_INT_WIDTH + i];
  for (int i = tid; i < REQ_FLOAT_WIDTH; i += THREADS)
    rf[i] = P.req_f[(size_t)lane * REQ_FLOAT_WIDTH + i];
  for (int i = tid; i < MAX_S * MAX_V; i += THREADS)
    s_cnt[i] = P.spread_counts[(size_t)lane * MAX_S * MAX_V + i];
  float* u = P.scratch + (size_t)lane * N * 3;
  for (int i = tid; i < N * 3; i += THREADS) u[i] = P.used[i];
  if (tid == 0) {
    n_placed = 0;
    done = 0;
  }
  __syncthreads();
  for (int i = tid; i < MAX_S * MAX_V; i += THREADS)
    s_hash[i] = ri[RI_S_VALUE_HASH + i];
  if (tid == 0) {
    // Lane base usage: used + in-flight deltas, in delta order.
    for (int j = 0; j < P.d; ++j) {
      const int r = P.delta_rows[(size_t)lane * P.d + j];
      if (r < 0 || r >= N) continue;
      for (int c = 0; c < 3; ++c)
        u[r * 3 + c] += P.delta_vals[((size_t)lane * P.d + j) * 3 + c];
    }
  }
  __syncthreads();

  const float ask0 = rf[RF_ASK], ask1 = rf[RF_ASK + 1], ask2 = rf[RF_ASK + 2];
  const int algorithm = ri[RI_ALGORITHM];
  const float desired_count = rf[RF_DESIRED_COUNT];
  const bool distinct = ri[RI_DISTINCT_HOSTS] != 0;
  const int pbucket = ri[RI_PREEMPT_BUCKET];
  const int kb = pbucket < 0 ? 0 : (pbucket > PRIO_BUCKETS ? PRIO_BUCKETS : pbucket);
  const int* tg_lane = P.tg_counts + (size_t)lane * N;
  const uint8_t* pen_lane = P.penalties + (size_t)lane * N;
  const uint8_t* hm_lane = P.host_masks + (size_t)lane * N;
  const uint8_t* ce_lane = P.class_eligs + (size_t)lane * P.k;

  // Affinity weight sum (step-invariant): Σ|w| over active slots, in order.
  float aff_wsum = 0.0f;
  for (int j = 0; j < P.a_width; ++j) {
    const float wgt = rf[RF_A_WEIGHT + j];
    aff_wsum = aff_wsum + fabsf(wgt) * (ri[RI_A_SLOT + j] >= 0 ? 1.0f : 0.0f);
  }
  bool has_spread = false;
  for (int s = 0; s < P.s_width; ++s) has_spread |= ri[RI_S_SLOT + s] >= 0;

  for (int step = 0; step < P.p; ++step) {
    if (tid == 0) {
      // Even-spread statistics over the carried value table.
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
    __syncthreads();

    Best best = {-CUDART_INF_F, 0x7fffffff, 0.0f, 0};
    int n_eval = 0, n_filt = 0, n_exh = 0;
    const int np_ = n_placed;

    for (int i = tid; i < N; i += THREADS) {
      // ---- feasibility (feasibility_mask, kernels.py:265; feasibility.cuh)
      bool elig;
      bool feas = node_feasible(P.m, i, ri, rf, P.c_width, P.ports != 0,
                                ce_lane, P.k, hm_lane, elig);
      int tg = tg_lane[i];
      for (int j = 0; j < np_; ++j) tg += placed[j] == i;
      feas = feas && !(distinct && tg > 0);

      // ---- fit and binpack (fit_and_binpack, kernels.py:308)
      const float t0 = P.totals[i * 3], t1 = P.totals[i * 3 + 1],
                  t2 = P.totals[i * 3 + 2];
      const float ut0 = u[i * 3] + ask0, ut1 = u[i * 3 + 1] + ask1,
                  ut2 = u[i * 3 + 2] + ask2;
      const bool fits = ut0 <= t0 && ut1 <= t1 && ut2 <= t2;
      const float free0 = 1.0f - ut0 / fmaxf(t0, 1.0f);
      const float free1 = 1.0f - ut1 / fmaxf(t1, 1.0f);
      const float total10 = exp2f(free0 * LOG2_10_F) + exp2f(free1 * LOG2_10_F);
      const float bp = fminf(fmaxf(20.0f - total10, 0.0f), 18.0f);
      const float sp = fminf(fmaxf(total10 - 2.0f, 0.0f), 18.0f);
      const float binpack = (algorithm == 1 ? sp : bp) * INV_18_F;

      // ---- preemption assist (preemption_state, kernels.py:462)
      bool needs_pre = false;
      float pre_component = 0.0f;
      if (P.preempt) {
        float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f, mid_max = 0.0f, mid_sum = 0.0f;
        const float* pu = P.prio_used + (size_t)i * PRIO_BUCKETS * 3;
        for (int bk = 0; bk < kb; ++bk) {
          const float q0 = pu[bk * 3], q1 = pu[bk * 3 + 1], q2 = pu[bk * 3 + 2];
          f0 = f0 + q0;
          f1 = f1 + q1;
          f2 = f2 + q2;
          const bool present = q0 > 0.0f || q1 > 0.0f || q2 > 0.0f;
          const float mid = present
              ? ((float)bk + 0.5f) * (101.0f / PRIO_BUCKETS) : 0.0f;
          mid_max = fmaxf(mid_max, mid);
          mid_sum = mid_sum + mid;
        }
        const bool usable = pbucket >= 0 && (f0 > 0.0f || f1 > 0.0f || f2 > 0.0f);
        const bool fwp = (ut0 - f0 <= t0) && (ut1 - f1 <= t1) && (ut2 - f2 <= t2);
        needs_pre = !fits && fwp && usable;
        if (needs_pre) {
          const float net = mid_max > 0.0f
              ? mid_max + mid_sum / fmaxf(mid_max, 1e-9f) : 0.0f;
          pre_component =
              1.0f / (1.0f + expf(PREEMPTION_RATE_F * (net - PREEMPTION_ORIGIN_F)));
        }
      }
      const bool fits_all = fits || needs_pre;

      // ---- anti-affinity and penalty (kernels.py:336, :346)
      const float coll = (float)tg;
      const bool aa_app = coll > 0.0f;
      const float aa = aa_app ? -(coll + 1.0f) / desired_count : 0.0f;
      const bool pen_app = pen_lane[i] != 0;
      const float pen = pen_app ? -1.0f : 0.0f;

      // ---- affinity (kernels.py:351)
      float aff_total = 0.0f;
      for (int j = 0; j < P.a_width; ++j) {
        const int slot = ri[RI_A_SLOT + j];
        const bool m = slot >= 0 &&
            check_predicate(P.m, i, slot, ri[RI_A_OP + j], ri[RI_A_HASH + j],
                            rf[RF_A_NUM + j]);
        aff_total = aff_total + (m ? 1.0f : 0.0f) * rf[RF_A_WEIGHT + j];
      }
      const bool aff_app = P.a_width > 0 && aff_total != 0.0f && aff_wsum > 0.0f;
      const float aff = aff_app ? aff_total / fmaxf(aff_wsum, 1e-9f) : 0.0f;

      // ---- spread (kernels.py:377)
      float spr_total = 0.0f;
      for (int s = 0; s < P.s_width; ++s) {
        int slot = ri[RI_S_SLOT + s];
        if (slot < 0) continue;
        if (slot >= P.m.a) slot = P.m.a - 1;
        const int nvalue = P.m.attr_hash[(size_t)i * P.m.a + slot];
        float count_at = 0.0f, desired_at = 0.0f;
        bool has_target = false;
        for (int v = 0; v < MAX_V; ++v) {
          const int vh = s_hash[s * MAX_V + v];
          const bool vm = nvalue == vh && vh != 0;
          count_at = count_at + (vm ? s_cnt[s * MAX_V + v] : 0.0f);
          const float des = rf[RF_S_DESIRED + s * MAX_V + v];
          const bool ok = vm && !isnan(des);
          has_target |= ok;
          desired_at = desired_at + (ok ? des : 0.0f);
        }
        float score;
        if (ri[RI_S_EVEN + s] != 0) {
          const float mn = s_mn[s], mx = s_mx[s];
          float eb;
          if (count_at != mn) {
            eb = mn == 0.0f ? -1.0f : (mn - count_at) / fmaxf(mn, 1e-9f);
          } else {
            eb = mn == mx ? -1.0f
                          : (mn == 0.0f ? 1.0f : (mx - mn) / fmaxf(mn, 1e-9f));
          }
          if (!s_any[s]) eb = 0.0f;
          score = nvalue != 0 ? eb : -1.0f;
        } else {
          float desired_v = has_target ? desired_at : CUDART_NAN_F;
          const float implicit = rf[RF_S_IMPLICIT + s];
          if (!has_target && !isnan(implicit)) desired_v = implicit;
          if (isnan(desired_v)) {
            score = -1.0f;
          } else {
            const float rel = rf[RF_S_WEIGHT + s] /
                              fmaxf(rf[RF_S_SUM_WEIGHTS], 1e-9f);
            score = ((desired_v - (count_at + 1.0f)) / fmaxf(desired_v, 1e-9f)) * rel;
          }
        }
        spr_total = spr_total + score;
      }
      const bool spr_app = has_spread && spr_total != 0.0f;
      const float spr = spr_app ? spr_total : 0.0f;

      // ---- mean of the appended components (score_nodes, kernels.py:565)
      const float total = binpack + aa + pen + aff + spr + pre_component;
      const float count = 1.0f + (aa_app ? 1.0f : 0.0f) + (pen_app ? 1.0f : 0.0f) +
                          (aff_app ? 1.0f : 0.0f) + (spr_app ? 1.0f : 0.0f) +
                          (needs_pre ? 1.0f : 0.0f);
      const float fin = (feas && fits_all) ? total / count : NEG_INF_F;

      n_eval += feas;
      n_filt += !feas && elig;
      n_exh += feas && !fits_all;
      if (better(fin, i, best.val, best.row)) {
        best.val = fin;
        best.row = i;
        best.bin = binpack;
        best.pre = needs_pre;
      }
    }

    // ---- block reduction: warp shuffles, then the warps' results
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
      n_eval += __shfl_down_sync(0xffffffffu, n_eval, off);
      n_filt += __shfl_down_sync(0xffffffffu, n_filt, off);
      n_exh += __shfl_down_sync(0xffffffffu, n_exh, off);
    }
    const int warp = tid >> 5;
    if ((tid & 31) == 0) {
      w_best[warp] = best;
      w_cnt[warp][0] = n_eval;
      w_cnt[warp][1] = n_filt;
      w_cnt[warp][2] = n_exh;
    }
    __syncthreads();

    if (tid == 0) {
      Best b = w_best[0];
      int ce = w_cnt[0][0], cf = w_cnt[0][1], cx = w_cnt[0][2];
      for (int wi = 1; wi < WARPS; ++wi) {
        const Best o = w_best[wi];
        if (better(o.val, o.row, b.val, b.row)) b = o;
        ce += w_cnt[wi][0];
        cf += w_cnt[wi][1];
        cx += w_cnt[wi][2];
      }
      const bool ok = b.val > NEG_INF_F / 2.0f;
      float* o = out + (size_t)step * PACKED_WIDTH;
      o[0] = ok ? (float)b.row : -1.0f;
      o[1] = ok ? b.val : 0.0f;
      o[2] = ok ? b.bin : 0.0f;
      o[3] = (ok && b.pre) ? 1.0f : 0.0f;
      o[4] = (float)ce;
      o[5] = (float)cf;
      o[6] = (float)cx;
      if (ok) {
        const int r = b.row;
        u[r * 3] += ask0;
        u[r * 3 + 1] += ask1;
        u[r * 3 + 2] += ask2;
        placed[n_placed] = r;
        n_placed = n_placed + 1;
        // apply_spread_values (kernels.py:677) on the winner's values.
        for (int s = 0; s < MAX_S; ++s) {
          const int slot = ri[RI_S_SLOT + s];
          int ss = slot < 0 ? 0 : slot;
          if (ss >= P.m.a) ss = P.m.a - 1;
          const int nv = P.m.attr_hash[(size_t)r * P.m.a + ss];
          int* vh = s_hash + s * MAX_V;
          int match = -1, free_slot = -1;
          for (int v = 0; v < MAX_V; ++v) {
            if (match < 0 && vh[v] == nv && nv != 0) match = v;
            if (free_slot < 0 && vh[v] == 0) free_slot = v;
          }
          const bool have = match >= 0;
          const int fs = free_slot < 0 ? 0 : free_slot;
          const int idx = have ? match : fs;
          const bool can = slot >= 0 && nv != 0 && (have || vh[fs] == 0);
          if (can && !have) vh[idx] = nv;
          if (can) s_cnt[s * MAX_V + idx] += 1.0f;
        }
      } else {
        // A failed step leaves the carry unchanged: every later step
        // gives the same output.
        for (int st = step + 1; st < P.p; ++st)
          for (int c = 0; c < PACKED_WIDTH; ++c)
            out[(size_t)st * PACKED_WIDTH + c] = o[c];
        done = 1;
      }
    }
    __syncthreads();
    if (done) break;
  }
}

extern "C" int nomad_fused_place(
    const float* totals, const float* used, const uint8_t* eligible,
    const int32_t* attr_hash, const float* attr_num, const float* attr_ver,
    const int32_t* class_id, const int32_t* dev_total, const int32_t* dev_used,
    const float* prio_used, const int32_t* port_words, const int32_t* dyn_used,
    const int32_t* delta_rows, const float* delta_vals,
    const int32_t* tg_counts, const float* spread_counts,
    const uint8_t* penalties, const int32_t* req_i, const float* req_f,
    const uint8_t* class_eligs, const uint8_t* host_masks,
    const uint8_t* lane_mask, float* out, float* scratch, int n, int a, int w,
    int b, int d, int k, int p, int c_width, int a_width, int s_width,
    int preempt, int ports, cudaStream_t stream) {
  if (p > MAX_PLACEMENTS || c_width > MAX_C || a_width > MAX_A ||
      s_width > MAX_S || n <= 0 || b <= 0 || k <= 0 || a <= 0)
    return (int)cudaErrorInvalidValue;
  FusedParams P;
  P.m.eligible = eligible;
  P.m.attr_hash = attr_hash;
  P.m.attr_num = attr_num;
  P.m.attr_ver = attr_ver;
  P.m.class_id = class_id;
  P.m.dev_total = dev_total;
  P.m.dev_used = dev_used;
  P.m.port_words = port_words;
  P.m.dyn_used = dyn_used;
  P.m.a = a;
  P.m.w = w;
  P.totals = totals;
  P.used = used;
  P.prio_used = prio_used;
  P.delta_rows = delta_rows;
  P.delta_vals = delta_vals;
  P.tg_counts = tg_counts;
  P.spread_counts = spread_counts;
  P.penalties = penalties;
  P.req_i = req_i;
  P.req_f = req_f;
  P.class_eligs = class_eligs;
  P.host_masks = host_masks;
  P.lane_mask = lane_mask;
  P.out = out;
  P.scratch = scratch;
  P.n = n;
  P.b = b;
  P.d = d;
  P.k = k;
  P.p = p;
  P.c_width = c_width;
  P.a_width = a_width;
  P.s_width = s_width;
  P.preempt = preempt;
  P.ports = ports;
  fused_place_kernel<<<b, THREADS, 0, stream>>>(P);
  return (int)cudaGetLastError();
}
