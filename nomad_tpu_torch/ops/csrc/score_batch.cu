// score_batch — B independent evaluations, each an argmax over every node.
//
// Replaces nomad_tpu/ops/kernels.py:score_batch (:627): the vmapped
// _score_and_pick (:601) over score_nodes (:525), the batched-eval
// program bench.py's kernel phase and __graft_entry__.entry() run.  Every
// lane scores all N rows against the shared usage `used` at step 0 (no
// carry, no deltas, every lane live) and keeps the best row: highest
// score, lowest row on ties (jnp.argmax).  A lane where nothing fits reads
// row -1 and zero score, binpack and preemption; its three node counters
// (evaluated, filtered, exhausted) are counted over all rows either way.
// The output is the packed (B, PACKED_WIDTH) float32 of ops/kernels.py.
//
// Design: one thread block per lane, its threads striding over the N rows
// with scoring.cuh's score_node (the code fused_place runs), then
// scoring.cuh's block_argmax.  The lane's packed request and spread
// counts sit in shared memory; the per-lane (B, N) operands (tg_counts,
// penalties, host_masks) are read coalesced, the shared node rows from L2.
//
// What bounds it on an H100: the bytes of the per-lane operands, 6 bytes
// a lane and node (tg_counts 4, penalties 1, host_masks 1): about 252 MB
// at B=4096 and N=10240, 0.075 ms at 3.35 TB/s; the node matrix itself is
// read once in that bound.  This design reads every node row once per
// lane from L2 (every lane re-reads the datacenter, attribute, device and
// usage columns it needs), so L2 traffic, not device memory, is what it
// waits on.  Tiling several lanes per block so a node row is read once
// into shared memory, and narrower tg_counts, are later work.
//
// Numerics: scoring.cuh's, built with -fmad=false and no fast math, so the
// kernel rounds exactly as the plain PyTorch version
// (ops/kernels.py:score_batch_plain).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "feasibility.cuh"
#include "layout.cuh"
#include "scoring.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)

struct ScoreBatchParams {
  NodeTables m;                // the columns feasibility reads
  const float* totals;         // (N, 3)
  const float* used;           // (N, 3), shared by every lane
  const float* prio_used;      // (N, PRIO_BUCKETS, 3)
  const int32_t* tg_counts;    // (B, N)
  const float* spread_counts;  // (B, MAX_S, MAX_V)
  const uint8_t* penalties;    // (B, N)
  const int32_t* req_i;        // (B, REQ_INT_WIDTH)
  const float* req_f;          // (B, REQ_FLOAT_WIDTH)
  const uint8_t* class_eligs;  // (B, K)
  const uint8_t* host_masks;   // (B, N)
  float* out;                  // (B, PACKED_WIDTH)
  int n, k;
  int c_width, a_width, s_width, preempt, ports;
};

__global__ void __launch_bounds__(THREADS)
score_batch_kernel(ScoreBatchParams P) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = P.n;

  __shared__ int ri[REQ_INT_WIDTH];
  __shared__ float rf[REQ_FLOAT_WIDTH];
  __shared__ float s_cnt[MAX_S * MAX_V];
  __shared__ float s_mn[MAX_S], s_mx[MAX_S];
  __shared__ int s_any[MAX_S];
  __shared__ Best w_best[WARPS];
  __shared__ int w_cnt[WARPS][3];

  for (int i = tid; i < REQ_INT_WIDTH; i += THREADS)
    ri[i] = P.req_i[(size_t)lane * REQ_INT_WIDTH + i];
  for (int i = tid; i < REQ_FLOAT_WIDTH; i += THREADS)
    rf[i] = P.req_f[(size_t)lane * REQ_FLOAT_WIDTH + i];
  for (int i = tid; i < MAX_S * MAX_V; i += THREADS)
    s_cnt[i] = P.spread_counts[(size_t)lane * MAX_S * MAX_V + i];
  __syncthreads();
  // The known spread values are the request's own (no carry).
  const int* s_hash = ri + RI_S_VALUE_HASH;
  if (tid == 0) even_spread_stats(s_hash, s_cnt, s_mn, s_mx, s_any);
  __syncthreads();

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
  L.aff_wsum = affinity_weight_sum(ri, rf, P.a_width);
  L.has_spread = any_spread(ri, P.s_width);
  L.c_width = P.c_width;
  L.a_width = P.a_width;
  L.s_width = P.s_width;
  L.preempt = P.preempt != 0;
  L.ports = P.ports != 0;

  const int32_t* tg_lane = P.tg_counts + (size_t)lane * N;
  const uint8_t* pen_lane = P.penalties + (size_t)lane * N;

  Best best = {-CUDART_INF_F, 0x7fffffff, 0.0f, 0};
  int n_eval = 0, n_filt = 0, n_exh = 0;
  for (int i = tid; i < N; i += THREADS) {
    const NodeScore s = score_node(P.m, P.totals, P.prio_used, P.used, i,
                                   tg_lane[i], pen_lane[i] != 0, L);
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
  if (tid == 0)
    write_packed(P.out + (size_t)lane * PACKED_WIDTH, best, n_eval, n_filt,
                 n_exh);
}

extern "C" int nomad_score_batch(
    const float* totals, const float* used, const uint8_t* eligible,
    const int32_t* attr_hash, const float* attr_num, const float* attr_ver,
    const int32_t* class_id, const int32_t* dev_total, const int32_t* dev_used,
    const float* prio_used, const int32_t* port_words, const int32_t* dyn_used,
    const int32_t* tg_counts, const float* spread_counts,
    const uint8_t* penalties, const int32_t* req_i, const float* req_f,
    const uint8_t* class_eligs, const uint8_t* host_masks, float* out, int n,
    int a, int w, int b, int k, int c_width, int a_width, int s_width,
    int preempt, int ports, cudaStream_t stream) {
  if (c_width > MAX_C || a_width > MAX_A || s_width > MAX_S || n <= 0 ||
      b <= 0 || k <= 0 || a <= 0)
    return (int)cudaErrorInvalidValue;
  ScoreBatchParams P;
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
  P.tg_counts = tg_counts;
  P.spread_counts = spread_counts;
  P.penalties = penalties;
  P.req_i = req_i;
  P.req_f = req_f;
  P.class_eligs = class_eligs;
  P.host_masks = host_masks;
  P.out = out;
  P.n = n;
  P.k = k;
  P.c_width = c_width;
  P.a_width = a_width;
  P.s_width = s_width;
  P.preempt = preempt;
  P.ports = ports;
  score_batch_kernel<<<b, THREADS, 0, stream>>>(P);
  return (int)cudaGetLastError();
}
