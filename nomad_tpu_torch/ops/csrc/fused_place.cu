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
// (apply_spread_values, kernels.py:677).  The per-node score and the
// block reduction are scoring.cuh's, shared with score_batch.cu.
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
#include "scoring.cuh"

#define THREADS 512
#define WARPS (THREADS / 32)
#define MAX_PLACEMENTS 64

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
  const int* tg_lane = P.tg_counts + (size_t)lane * N;
  const uint8_t* pen_lane = P.penalties + (size_t)lane * N;

  LaneView L;
  L.ri = ri;
  L.rf = rf;
  L.s_hash = s_hash;
  L.s_cnt = s_cnt;
  L.s_mn = s_mn;
  L.s_mx = s_mx;
  L.s_any = s_any;
  L.class_elig = P.class_eligs + (size_t)lane * P.k;
  L.k = P.k;
  L.host_mask = P.host_masks + (size_t)lane * N;
  // Affinity weight sum and spread presence are step-invariant.
  L.aff_wsum = affinity_weight_sum(ri, rf, P.a_width);
  L.has_spread = any_spread(ri, P.s_width);
  L.c_width = P.c_width;
  L.a_width = P.a_width;
  L.s_width = P.s_width;
  L.preempt = P.preempt != 0;
  L.ports = P.ports != 0;

  for (int step = 0; step < P.p; ++step) {
    // Even-spread statistics over the carried value table.
    if (tid == 0) even_spread_stats(s_hash, s_cnt, s_mn, s_mx, s_any);
    __syncthreads();

    Best best = {-CUDART_INF_F, 0x7fffffff, 0.0f, 0};
    int n_eval = 0, n_filt = 0, n_exh = 0;
    const int np_ = n_placed;

    for (int i = tid; i < N; i += THREADS) {
      int tg = tg_lane[i];
      for (int j = 0; j < np_; ++j) tg += placed[j] == i;
      const NodeScore s = score_node(P.m, P.totals, P.prio_used, u, i, tg,
                                     pen_lane[i] != 0, L);
      n_eval += s.feas;
      n_filt += !s.feas && s.elig;
      n_exh += s.feas && !s.fits_all;
      if (better(s.fin, i, best.val, best.row)) {
        best.val = s.fin;
        best.row = i;
        best.bin = s.binpack;
        best.pre = s.needs_pre;
      }
    }

    block_argmax<WARPS>(best, n_eval, n_filt, n_exh, w_best, w_cnt);

    if (tid == 0) {
      float* o = out + (size_t)step * PACKED_WIDTH;
      const bool ok = write_packed(o, best, n_eval, n_filt, n_exh);
      if (ok) {
        const int r = best.row;
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
