// sharded_place — the node-sharded placement scan: one step of every lane
// of every node shard on a card, in one launch.
//
// Replaces the per-shard bodies of the JAX package's node-sharded programs
// (nomad_tpu/parallel/sharding.py): _place_batch_local (:334, the staged
// sharded dispatch), the ranking scan of _fused_place_batch_local (:480,
// TOPK_K = 1, so the hierarchical top-k is each shard's argmax) and
// _step_local (:243, one step with no carried state).  There the node axis
// is split over a ('batch', 'node') mesh and pmax/pmin/psum reduce across
// shards inside one SPMD program.  Here the shards of a card run in one
// launch a step, and the reduction across shards is a table of offers on
// each card that the next launch reads.
//
// What bounds it on an H100: neither the bytes nor the arithmetic (the
// function needs the few MB and ~1e7 operations fused_place.cu needs at
// B=64, N=10240, P=16), but the P dependent steps: every step's winner is
// an argmax over every node shard that the next step needs, and no launch
// may wait on another inside the device (virtual shards of one card would
// deadlock), so a step is a launch.  The first design rescored every row
// of a shard at every step, one CTA a lane, one launch a shard and a step
// with the offers copied between shards' tables after each (PERF.md: 61.6
// us a launch, 68 launches and 64 copies a dispatch at 4 virtual shards).
//
// Design: the hoisted scan of fused_place.cu (place_scan.cuh), cut into
// launches.
// * A launch covers every (batch row, node shard) pair on its card, up to
//   SP_MAX_PAIRS, through a table of pair descriptors in its
//   __grid_constant__ parameters: each pair's columns, row offset and lane
//   operands.  Grid (C, lanes, pairs); each (lane, pair) runs on a cluster
//   of C CTAs of 128 threads (four CTAs an SM; C from 2 to 8, so that a
//   launch about fills the card in one wave), and CTA r owns a span of the
//   shard's rows.
// * Launch 0 scores each owned row once with the full score and keeps the
//   candidates (place_scan.cuh keep_candidates), four rows a thread at a
//   time.  The lane's usage where it differs from `used` (its in-flight
//   deltas on the CTA's rows, each row's sum built in delta order by the
//   thread of its first delta) is a small table; a per-row index in shared
//   memory finds a row's entry in one read.
// * Every launch t < P scores the value tables' entries, takes each CTA's
//   best candidate, and the CTAs of a cluster exchange (score, row,
//   binpack, preemption, counters) through distributed shared memory after
//   a cluster barrier; CTA 0 writes the pair's offer for step t (its best
//   row's spread values with it) into the card's offer table.
// * Every launch t > 0 first reduces step t-1's offers of its batch row's
//   shards, one shard a thread of a warp (highest score, then the lowest
//   GLOBAL row; counters summed), so every pair of the row picks the same
//   winner; the row's first shard writes the packed row.  The winner's
//   owner CTA rescores that one row (usage, tg count, fit, preemption,
//   anti-affinity, distinct_hosts; its usage entry found by a warp), every
//   CTA applies the winner's spread values to its tables, and a value new
//   to a table moves the candidates holding it off "no match".  Launch P
//   only reduces and writes.
// * A CTA's state lives between launches in a device scratch the wrapper
//   sizes (nomad_sharded_place_shape): the digested request (LaneSetup),
//   the value tables, the placed rows, the usage table and the candidates.
//   A later step reads the candidates' state, not the shard's columns.
// * Shards on one card read each other's offers from the card's table
//   (two parities, step & 1); the wrapper copies offers only to other
//   cards, ordered by CUDA events.
//
// Rows past the claimed ones inside a shard's block are not eligible
// (NodeMatrix zeroes them), so they are never feasible and never win.
//
// Numerics: built without --use_fast_math and with -fmad=false, as the
// other kernels: every score rounds as in fused_place.cu and the plain
// PyTorch version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "feasibility.cuh"
#include "layout.cuh"
#include "per_device.cuh"
#include "place_scan.cuh"
#include "scoring.cuh"

namespace cg = cooperative_groups;

#define SP_THREADS 128
#define SP_WARPS (SP_THREADS / 32)
#define SP_MAX_PLACEMENTS 64
#define SP_MAX_PAIRS 16    // (batch row, node shard) pairs a launch covers
#define SP_MAX_SHARDS 32   // node shards of a batch row (a warp reduces them)
#define SP_MAX_CLUSTER 8
#define SP_SMEM_BUDGET (96 * 1024)
#define SP_NO_ENTRY 0xffff
// An offer: score bits, global row, binpack bits, preemption flag, the
// three counters, the best row's value hash per spread stanza, padding.
#define OFFER_WORDS 12

// One (batch row, node shard) pair: the shard's rows on this card and the
// lanes of its batch row.  ops/kernels.py _SPPair mirrors this layout.
struct SPPair {
  NodeTables m;                // the shard's columns feasibility reads
  const float* totals;         // (n, 3)
  const float* used;           // (n, 3)
  const float* prio_used;      // (n, PRIO_BUCKETS, 3)
  const int32_t* delta_rows;   // (b, d) global rows
  const float* delta_vals;     // (b, d, 3)
  const int32_t* tg_counts;    // (b, n)
  const float* spread_counts;  // (b, MAX_S, MAX_V)
  const uint8_t* penalties;    // (b, n)
  const int32_t* req_i;        // (b, REQ_INT_WIDTH)
  const float* req_f;          // (b, REQ_FLOAT_WIDTH)
  const uint8_t* class_eligs;  // (b, k)
  const uint8_t* host_masks;   // (b, n)
  const uint8_t* lane_mask;    // (b,)
  unsigned char* scratch;      // (b, C, cta_bytes) the CTAs' state
  float* out;                  // (b, P, PACKED_WIDTH); null but on shard 0
  int n, off, b, d, k, row, shard, shards;
};

struct SPParams {
  SPPair pair[SP_MAX_PAIRS];
  int32_t* table;  // (2, rows, shards_max, b_max, OFFER_WORDS) on this card
  size_t cta_bytes;
  int q, p, step, span, umax, rows, shards_max, b_max;
  RunWidths rw;
};

// A CTA's counters and sizes between launches.
struct SPHead {
  int n_cand, my_cand, n_umap, n_placed;
  int cnt[3], pad;
};

// A CTA's scratch: its head, the digested request, the value tables (hash,
// count), the placed rows, the usage table, the candidates.
template <class W>
struct SPLayout {
  static __host__ __device__ size_t setup() { return align16(sizeof(SPHead)); }
  static __host__ __device__ size_t tables() {
    return setup() + align16(sizeof(LaneSetup<W>));
  }
  static __host__ __device__ size_t placed() {
    return tables() + align16(2 * MAX_S * MAX_V * 4);
  }
  static __host__ __device__ size_t umap() {
    return placed() + align16(SP_MAX_PLACEMENTS * 4);
  }
  static __host__ __device__ size_t cands(int umax) {
    return umap() + align16((size_t)umax * sizeof(UEntry));
  }
  static __host__ __device__ size_t bytes(int umax, int span) {
    return cands(umax) + align16((size_t)span * cand_bytes<W>());
  }
};

template <class W>
__global__ void __launch_bounds__(SP_THREADS, 4)
sharded_place_kernel(const __grid_constant__ SPParams P) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const SPPair& Q = P.pair[blockIdx.z];
  const int lane = blockIdx.y;
  const bool lead = Q.out != nullptr;  // the batch row's first shard
  // The whole cluster takes these exits together.
  if (lane >= Q.b || (P.step == P.p && !lead)) return;
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const int N = Q.n;
  const int begin = rank * P.span;
  const int nloc = max(0, min(N, begin + P.span) - begin);
  float* out = lead ? Q.out + (size_t)lane * P.p * PACKED_WIDTH : nullptr;

  if (!Q.lane_mask[lane]) {  // dead lane: row -1, zeros
    if (lead && rank == 0 && P.step == 0)
      for (int i = tid; i < P.p * PACKED_WIDTH; i += SP_THREADS)
        out[i] = (i % PACKED_WIDTH == 0) ? -1.0f : 0.0f;
    return;
  }

  unsigned char* base =
      Q.scratch + ((size_t)lane * n_ranks + rank) * P.cta_bytes;
  SPHead* hd = (SPHead*)base;
  int32_t* g_setup = (int32_t*)(base + SPLayout<W>::setup());
  int32_t* g_hash = (int32_t*)(base + SPLayout<W>::tables());
  int32_t* g_cnt = g_hash + MAX_S * MAX_V;
  int32_t* g_placed = (int32_t*)(base + SPLayout<W>::placed());
  UEntry* umap = (UEntry*)(base + SPLayout<W>::umap());
  const Cands<W> cd = cands_at<W>(base + SPLayout<W>::cands(P.umax), P.span);

  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* rowent = (uint16_t*)smem;  // launch 0: each owned row's entry

  __shared__ int ri[REQ_INT_WIDTH];
  __shared__ float rf[REQ_FLOAT_WIDTH];
  __shared__ LaneSetup<W> L;
  __shared__ int s_hash[MAX_S * MAX_V];
  __shared__ float s_cnt[MAX_S * MAX_V];
  __shared__ float s_mn[MAX_S], s_mx[MAX_S];
  __shared__ int s_any[MAX_S];
  __shared__ float esc[AtLeast1<W::SW>::value][SPR_ENTRIES];
  __shared__ int ins_entry[MAX_S], ins_hash[MAX_S];
  __shared__ int placed[SP_MAX_PLACEMENTS];
  __shared__ int s_drow[MAX_LANE_DELTAS];
  __shared__ int n_placed, n_umap, n_cand, my_cand, win_shard;
  __shared__ int cnt[3];
  __shared__ Xchg xchg;
  __shared__ Xchg win;
  __shared__ Best w_best[SP_WARPS];
  __shared__ int w_cand[SP_WARPS];
  constexpr int SETUP_WORDS = sizeof(LaneSetup<W>) / 4;

  for (int i = tid; i < REQ_INT_WIDTH; i += SP_THREADS)
    ri[i] = Q.req_i[(size_t)lane * REQ_INT_WIDTH + i];
  for (int i = tid; i < REQ_FLOAT_WIDTH; i += SP_THREADS)
    rf[i] = Q.req_f[(size_t)lane * REQ_FLOAT_WIDTH + i];

  const int32_t* tab_prev =
      P.step > 0
          ? P.table + ((size_t)((P.step - 1) & 1) * P.rows + Q.row) *
                          P.shards_max * P.b_max * OFFER_WORDS
          : nullptr;
  if (P.step == 0) {
    for (int i = tid; i < MAX_S * MAX_V; i += SP_THREADS)
      s_cnt[i] = Q.spread_counts[(size_t)lane * MAX_S * MAX_V + i];
    for (int i = tid; i < nloc; i += SP_THREADS) rowent[i] = SP_NO_ENTRY;
    for (int j = tid; j < Q.d; j += SP_THREADS)
      s_drow[j] = Q.delta_rows[(size_t)lane * Q.d + j];
    if (tid == 0) {
      n_umap = n_cand = n_placed = 0;
      cnt[0] = cnt[1] = cnt[2] = 0;
    }
  } else {
    // This CTA's state from the launch before; step - 1's offers of the
    // batch row's shards, one a thread of warp 0.
    for (int i = tid; i < SETUP_WORDS; i += SP_THREADS)
      ((int32_t*)&L)[i] = g_setup[i];
    for (int i = tid; i < MAX_S * MAX_V; i += SP_THREADS) {
      s_hash[i] = g_hash[i];
      s_cnt[i] = __int_as_float(g_cnt[i]);
    }
    for (int i = tid; i < P.p; i += SP_THREADS) placed[i] = g_placed[i];
    if (tid == 32) {
      n_cand = hd->n_cand;
      my_cand = hd->my_cand;
      n_umap = hd->n_umap;
      n_placed = hd->n_placed;
      cnt[0] = hd->cnt[0];
      cnt[1] = hd->cnt[1];
      cnt[2] = hd->cnt[2];
    }
    if (warp == 0) {
      Best b = {-CUDART_INF_F, 0x7fffffff, 0.0f, 0};
      int c0 = 0, c1 = 0, c2 = 0, ws = 0;
      if (lid < Q.shards) {
        const int32_t* o = tab_prev + ((size_t)lid * P.b_max + lane) * OFFER_WORDS;
        b = {__int_as_float(o[0]), o[1], __int_as_float(o[2]), o[3]};
        c0 = o[4];
        c1 = o[5];
        c2 = o[6];
        ws = lid;
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, b.val, off);
        const int orow = __shfl_down_sync(0xffffffffu, b.row, off);
        const float ob = __shfl_down_sync(0xffffffffu, b.bin, off);
        const int op = __shfl_down_sync(0xffffffffu, b.pre, off);
        const int os = __shfl_down_sync(0xffffffffu, ws, off);
        if (better(ov, orow, b.val, b.row)) {
          b = {ov, orow, ob, op};
          ws = os;
        }
      }
      c0 = __reduce_add_sync(0xffffffffu, c0);
      c1 = __reduce_add_sync(0xffffffffu, c1);
      c2 = __reduce_add_sync(0xffffffffu, c2);
      if (lid == 0) {
        win.best = b;
        win.c0 = c0;
        win.c1 = c1;
        win.c2 = c2;
        win_shard = ws;
      }
    }
  }
  __syncthreads();

  if (P.step == 0) {
    for (int i = tid; i < MAX_S * MAX_V; i += SP_THREADS)
      s_hash[i] = ri[RI_S_VALUE_HASH + i];
    if (tid == 0) lane_setup<W>(L, ri, rf, P.rw, Q.m.a);
    // Lane base usage on this CTA's rows: used + in-flight deltas, in delta
    // order; the thread of a row's first delta sums all of them.
    for (int j = tid; j < Q.d; j += SP_THREADS) {
      const int g = s_drow[j];
      const int r = g - Q.off;
      if (r < begin || r >= begin + nloc) continue;
      bool first = true;
      for (int jj = 0; jj < j && first; ++jj) first = s_drow[jj] != g;
      if (!first) continue;
      float u0 = Q.used[r * 3], u1 = Q.used[r * 3 + 1], u2 = Q.used[r * 3 + 2];
      for (int jj = j; jj < Q.d; ++jj) {
        if (s_drow[jj] != g) continue;
        const float* dv = Q.delta_vals + ((size_t)lane * Q.d + jj) * 3;
        u0 += dv[0];
        u1 += dv[1];
        u2 += dv[2];
      }
      const int e = atomicAdd(&n_umap, 1);
      umap[e] = {r, u0, u1, u2};
      rowent[r - begin] = (uint16_t)e;
    }
    __syncthreads();

    // ---- score every owned row once; keep the candidates.
    GlobalNodes S;
    S.m = &Q.m;
    S.totals = Q.totals;
    const uint8_t* class_elig = Q.class_eligs + (size_t)lane * Q.k;
    const int32_t* tg_lane = Q.tg_counts + (size_t)lane * N;
    const uint8_t* pen_lane = Q.penalties + (size_t)lane * N;
    const uint8_t* host_lane = Q.host_masks + (size_t)lane * N;
    int c0 = 0, c1 = 0, c2 = 0;
    constexpr int K = 4;
    for (int b0 = warp * 32 * K; b0 < nloc; b0 += SP_THREADS * K) {
      int li[K], row[K];
      bool host[K], feas0[K], elig[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        li[j] = b0 + lid + 32 * j;
        const bool valid = li[j] < nloc;
        row[j] = begin + (valid ? li[j] : 0);
        host[j] = valid && host_lane[row[j]] != 0;
      }
      feasible_k<W, K>(S, li, row, L, class_elig, Q.k, host, feas0, elig);
      keep_candidates<W, K>(
          S, L, Q.used, Q.prio_used, tg_lane, pen_lane, li, row, nloc, feas0,
          elig, s_hash, cd, P.span, &n_cand, c0, c1, c2,
          [&](int l, int, float& u0, float& u1, float& u2) {
            const int e = rowent[l];
            if (e == SP_NO_ENTRY) return false;
            u0 = umap[e].u0;
            u1 = umap[e].u1;
            u2 = umap[e].u2;
            return true;
          });
    }
    c0 = __reduce_add_sync(0xffffffffu, c0);
    c1 = __reduce_add_sync(0xffffffffu, c1);
    c2 = __reduce_add_sync(0xffffffffu, c2);
    if (lid == 0) {
      atomicAdd(&cnt[0], c0);
      atomicAdd(&cnt[1], c1);
      atomicAdd(&cnt[2], c2);
    }
  } else {
    const Best wb = win.best;
    const bool ok = wb.val > NEG_INF_F / 2.0f;
    if (lead && rank == 0 && tid == 0) {
      float* o = out + (size_t)(P.step - 1) * PACKED_WIDTH;
      o[0] = ok ? (float)wb.row : -1.0f;
      o[1] = ok ? wb.val : 0.0f;
      o[2] = ok ? wb.bin : 0.0f;
      o[3] = (ok && wb.pre) ? 1.0f : 0.0f;
      o[4] = (float)win.c0;
      o[5] = (float)win.c1;
      o[6] = (float)win.c2;
    }
    // The last launch only writes; a failed step leaves the carry as it
    // was, so the next step gives the same output.
    if (P.step == P.p) return;
    if (ok) {
      // ---- the carry: thread 0 applies the winner's spread values (its
      // owner recorded them in the offer) while warp 1 rescores the winner
      // in its owner CTA.
      if (tid == 0) {
        const int32_t* wo =
            tab_prev + ((size_t)win_shard * P.b_max + lane) * OFFER_WORDS;
        for (int s = 0; s < MAX_S; ++s) {
          const int nv = wo[7 + s];
          apply_spread_value(s, ri[RI_S_SLOT + s], nv, s_hash, s_cnt,
                             &ins_entry[s]);
          ins_hash[s] = nv;
        }
      }
      if (warp == 1) {
        const int r = wb.row - Q.off;
        const bool mine = r >= begin && r < begin + nloc;
        int e = -1;
        if (mine)
          for (int e0 = 0; e0 < n_umap; e0 += 32) {
            const unsigned hit = __ballot_sync(
                0xffffffffu, e0 + lid < n_umap && umap[e0 + lid].row == r);
            if (hit) {
              e = e0 + __ffs(hit) - 1;
              break;
            }
          }
        if (lid == 0) {
          placed[n_placed++] = wb.row;
          if (mine) {
            if (e < 0) {
              e = n_umap++;
              umap[e] = {r, Q.used[r * 3], Q.used[r * 3 + 1], Q.used[r * 3 + 2]};
            }
            UEntry u = umap[e];
            u.u0 += L.ask0;
            u.u1 += L.ask1;
            u.u2 += L.ask2;
            umap[e] = u;
            int tg = Q.tg_counts[(size_t)lane * N + r];
            for (int j = 0; j < n_placed; ++j) tg += placed[j] == wb.row;
            rescore_winner<W>(cd, my_cand, L, Q.prio_used, r, u.u0, u.u1, u.u2,
                              Q.totals[r * 3], Q.totals[r * 3 + 1],
                              Q.totals[r * 3 + 2], tg, cnt);
          }
        }
      }
      __syncthreads();
      // A value new to a table: the candidates holding it leave "no match".
      enter_values<W, SP_THREADS>(cd, n_cand, P.span, ins_entry, ins_hash);
    }
  }
  __syncthreads();

  // ---- step P.step: this CTA's best candidate, then the cluster's offer.
  if (tid == 0) even_spread_stats(s_hash, s_cnt, s_mn, s_mx, s_any);
  __syncthreads();
  spread_entry_scores<W, SP_THREADS>(esc, L, ri, rf, s_hash, s_cnt, s_mn, s_mx,
                                     s_any);
  __syncthreads();
  const int nc = n_cand;
  Best best;
  int bc;
  block_best<W, SP_THREADS>(cd, nc, P.span, L, esc, w_best, w_cand, best, bc);
  if (tid == 0) {
    xchg.best = best;
    xchg.c0 = cnt[0];
    xchg.c1 = cnt[1];
    xchg.c2 = cnt[2];
    hd->n_cand = nc;
    hd->my_cand = bc;
    hd->n_umap = n_umap;
    hd->n_placed = n_placed;
    hd->cnt[0] = cnt[0];
    hd->cnt[1] = cnt[1];
    hd->cnt[2] = cnt[2];
  }
  // The state the next launch reads.
  if (P.step == 0)
    for (int i = tid; i < SETUP_WORDS; i += SP_THREADS)
      g_setup[i] = ((const int32_t*)&L)[i];
  for (int i = tid; i < MAX_S * MAX_V; i += SP_THREADS) {
    g_hash[i] = s_hash[i];
    g_cnt[i] = __float_as_int(s_cnt[i]);
  }
  for (int i = tid; i < n_placed; i += SP_THREADS) g_placed[i] = placed[i];
  cluster.sync();
  if (rank == 0 && warp == 0) {
    Xchg o;
    if (lid < n_ranks) {
      o = *cluster.map_shared_rank(&xchg, lid);
    } else {
      o.best = {-CUDART_INF_F, 0x7fffffff, 0.0f, 0};
      o.c0 = o.c1 = o.c2 = 0;
    }
    Best b = o.best;
    int c0 = o.c0, c1 = o.c1, c2 = o.c2;
    warp_best(b, c0, c1, c2);
    if (lid == 0) {
      const bool any = b.row != 0x7fffffff;
      int32_t* w = P.table +
                   ((((size_t)(P.step & 1) * P.rows + Q.row) * P.shards_max +
                     Q.shard) * P.b_max + lane) * OFFER_WORDS;
      w[0] = __float_as_int(b.val);
      w[1] = any ? b.row + Q.off : 0x7fffffff;
      w[2] = __float_as_int(b.bin);
      w[3] = b.pre;
      w[4] = c0;
      w[5] = c1;
      w[6] = c2;
      // The spread values of this pair's best row, for its owner's offer.
      for (int s = 0; s < MAX_S; ++s) {
        int ss = ri[RI_S_SLOT + s];
        ss = ss < 0 ? 0 : ss;
        if (ss >= Q.m.a) ss = Q.m.a - 1;
        w[7 + s] = any ? Q.m.attr_hash[(size_t)b.row * Q.m.a + ss] : 0;
      }
      for (int i = 7 + MAX_S; i < OFFER_WORDS; ++i) w[i] = 0;
    }
  }
  cluster.sync();  // keep this CTA's offer alive until CTA 0 read it
}

// sharded_usage: the step's usage update on one node shard, the scatter of
// every pick's ask and the psum over 'batch' of the reference's
// _step_local (nomad_tpu/parallel/sharding.py:284-294).  used_after[r] =
// used[r] + delta[r]; delta sums, batch row by batch row in mesh order,
// each row's part, and a part sums the asks of that row's lanes (in lane
// order) whose pick is global row off + r.  One thread a local row; every
// thread reads the B picks (step 0's row of the gathered (B, P, 7) result)
// and their asks, a few KB that L1 serves.
#define SU_THREADS 256

__global__ void __launch_bounds__(SU_THREADS)
sharded_usage_kernel(const float* used, const float* packed,
                     const float* req_f, float* out, int n, int off, int b,
                     int p, int n_batch) {
  const int r = blockIdx.x * SU_THREADS + threadIdx.x;
  if (r >= n) return;
  const int per = b / n_batch;
  const int want = off + r;
  float dl[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < n_batch; ++i) {
    float part[3] = {0.0f, 0.0f, 0.0f};
    for (int lane = i * per; lane < (i + 1) * per; ++lane) {
      if ((int)packed[(size_t)lane * p * PACKED_WIDTH] != want) continue;
      const float* ask = req_f + (size_t)lane * REQ_FLOAT_WIDTH + RF_ASK;
      for (int c = 0; c < 3; ++c) part[c] += ask[c];
    }
    for (int c = 0; c < 3; ++c) dl[c] = dl[c] + part[c];
  }
  for (int c = 0; c < 3; ++c)
    out[(size_t)r * 3 + c] = used[(size_t)r * 3 + c] + dl[c];
}

// Launch shape: cluster size, each CTA's row span, scratch bytes per CTA,
// dynamic shared memory, instantiation tier.
struct SPShape {
  int c, span, tier;
  size_t cta_bytes, smem;
};

static SPShape sp_shape(int n, int lanes, int d, int p, const RunWidths& rw) {
  SPShape sh;
  sh.tier = widths_tier(rw);
  // Four CTAs an SM: a cluster for every (lane, pair), together about one
  // wave of the card.
  int c = 4 * nomad_sm_count() / (lanes > 0 ? lanes : 1);
  if (c < 2) c = 2;
  if (c > SP_MAX_CLUSTER) c = SP_MAX_CLUSTER;
  sh.c = c;
  const int each = (n + c - 1) / c;
  sh.span = (each + 31) / 32 * 32;
  const int umax = d + p;
  sh.cta_bytes = sh.tier == 0 ? SPLayout<WidthsBench>::bytes(umax, sh.span)
                              : SPLayout<WidthsFull>::bytes(umax, sh.span);
  sh.smem = align16((size_t)sh.span * sizeof(uint16_t));
  return sh;
}

// The launch shape of a launch over pairs of at most `n` rows and
// `lanes` lanes in all: {cluster size, row span per CTA, scratch bytes per
// CTA, dynamic shared memory bytes, instantiation tier}.
extern "C" int nomad_sharded_place_shape(int n, int lanes, int d, int p,
                                         int c_width, int a_width,
                                         int s_width, int preempt, int ports,
                                         long long* out) {
  const SPShape sh =
      sp_shape(n, lanes, d, p, {c_width, a_width, s_width, preempt, ports});
  out[0] = sh.c;
  out[1] = sh.span;
  out[2] = (long long)sh.cta_bytes;
  out[3] = (long long)sh.smem;
  out[4] = sh.tier;
  return 5;
}

// sizeof(SPPair): the wrapper checks its descriptor layout against it.
extern "C" int nomad_sharded_pair_bytes() { return (int)sizeof(SPPair); }

template <class W>
static int sp_launch(const SPParams& P, const SPShape& sh, int c,
                     cudaStream_t stream) {
  static bool attr_set[NOMAD_MAX_DEVICES];
  {
    const cudaError_t e =
        nomad_smem_once(attr_set, sharded_place_kernel<W>, SP_SMEM_BUDGET);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, P.b_max, P.q);
  cfg.blockDim = dim3(SP_THREADS, 1, 1);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, sharded_place_kernel<W>, P);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One step of every pair in `pairs` (q of them, all on the current card):
// launch `step` of P + 1.  `table` is the card's offer table; every pair's
// scratch holds b x C x cta_bytes bytes of the shape this entry's
// arguments give nomad_sharded_place_shape (n the pairs' largest, lanes
// their sum, d their largest).
extern "C" int nomad_sharded_place(const SPPair* pairs, int q, int32_t* table,
                                   int rows, int shards_max, int b_max, int p,
                                   int step, int c_width, int a_width,
                                   int s_width, int preempt, int ports,
                                   cudaStream_t stream) {
  if (q < 1 || q > SP_MAX_PAIRS || p < 1 || p > SP_MAX_PLACEMENTS ||
      step < 0 || step > p || rows < 1 || shards_max < 1 ||
      shards_max > SP_MAX_SHARDS || b_max < 1 || table == nullptr ||
      c_width < 0 || c_width > MAX_C || a_width < 0 || a_width > MAX_A ||
      s_width < 0 || s_width > MAX_S)
    return (int)cudaErrorInvalidValue;
  SPParams P;
  int n_max = 0, lanes = 0, d_max = 0;
  for (int i = 0; i < q; ++i) {
    const SPPair& Q = pairs[i];
    if (Q.n <= 0 || Q.b <= 0 || Q.b > b_max || Q.k <= 0 || Q.m.a <= 0 ||
        Q.d < 0 || Q.d > MAX_LANE_DELTAS || Q.off < 0 || Q.row < 0 ||
        Q.row >= rows || Q.shards < 1 || Q.shards > shards_max ||
        Q.shard < 0 || Q.shard >= Q.shards || Q.scratch == nullptr ||
        (Q.shard == 0) != (Q.out != nullptr))
      return (int)cudaErrorInvalidValue;
    P.pair[i] = Q;
    n_max = Q.n > n_max ? Q.n : n_max;
    d_max = Q.d > d_max ? Q.d : d_max;
    lanes += Q.b;
  }
  P.rw = {c_width, a_width, s_width, preempt, ports};
  const SPShape sh = sp_shape(n_max, lanes, d_max, p, P.rw);
  if (sh.smem > SP_SMEM_BUDGET) return (int)cudaErrorInvalidValue;
  P.table = table;
  P.cta_bytes = sh.cta_bytes;
  P.q = q;
  P.p = p;
  P.step = step;
  P.span = sh.span;
  P.umax = d_max + p;
  P.rows = rows;
  P.shards_max = shards_max;
  P.b_max = b_max;
  if (sh.tier == 0) return sp_launch<WidthsBench>(P, sh, sh.c, stream);
  return sp_launch<WidthsFull>(P, sh, sh.c, stream);
}

extern "C" int nomad_sharded_usage(const float* used, const float* packed,
                                   const float* req_f, float* out, int n,
                                   int row_offset, int b, int p, int n_batch,
                                   cudaStream_t stream) {
  if (n <= 0 || b <= 0 || p < 1 || row_offset < 0 || n_batch < 1 ||
      b % n_batch)
    return (int)cudaErrorInvalidValue;
  sharded_usage_kernel<<<(n + SU_THREADS - 1) / SU_THREADS, SU_THREADS, 0,
                         stream>>>(used, packed, req_f, out, n, row_offset,
                                   b, p, n_batch);
  return (int)cudaGetLastError();
}
