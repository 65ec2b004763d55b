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
//
// The file's second entry, sharded_usage (below), is the sharded step's
// usage update (sharding.py:284-294): an ordered list of each CTA's picks
// built with warp ballots, each batch row's segment walked in staged
// windows, no atomics; its notes stand beside it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
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
// order) whose pick is global row off + r.
//
// What bounds it on an H100: the bytes are the copy of `used` into `out`
// (123 KB at 5,120 rows) and a few KB of picks and asks, well under a
// microsecond at 3.35 TB/s.  The time goes to launch latency, the
// dependent round trips to L2, and, where many lanes pick one node (a
// batch of identical requests all picks the same best node), the chain
// of float32 adds that the fixed summation order makes sequential.  The
// first design gave each thread one row and made it read all B picks
// (n x B reads: 21 M at B = 4,096 on 5,120 rows).
//
// Design (no atomics: the sums keep one order, the plain version's):
// * The grid covers the card: each CTA owns a span of at most SU_THREADS
//   rows (a multiple of 4), about n / SMs of them, and loads its rows of
//   `used` first, for the last phase.
// * Every CTA reads the B picks once, SU_GROUP chunks of SU_THREADS lanes
//   at a time (all loads of a group in flight together).  A warp ballot
//   per chunk and one prefix sum a group over the (chunk, warp) counts
//   append the lanes whose pick falls in the CTA's span to a list in
//   shared memory, in lane order: 16-bit lane, 8-bit row.  The list holds
//   B entries, so B is at most SU_MAX_LANES (the wrapper refuses more).
//   A CTA whose list is empty writes out = used + 0.0 at once.
// * Batch rows are contiguous lanes, so each batch row is a segment of
//   the list.  With n_batch <= SU_MAX_G and room for it, a warp-aligned
//   group of threads walks each batch row's segment (one thread a row),
//   so a hot row's parts add up in parallel; else one thread a row walks
//   the whole list, closing a part when the batch row changes.
// * Windows of SU_WIN entries (each group's next ones) are staged: the
//   ask and batch row as a float4 and the row byte, the next window's
//   loads in flight while the current one is walked.  Each 16-entry
//   block whose entries all lie on one row is marked with it, and that
//   row's thread adds a run of such blocks from registers, the next 16
//   loaded ahead (the chain of dependent adds is the floor there); any
//   other block is walked entry by entry.
// * Each row's parts are then added in batch-row order, and the CTA's
//   rows written out = used + delta with 16-byte accesses (a row without
//   a pick adds 0.0, as the plain version does).
#define SU_THREADS 256
#define SU_WARPS (SU_THREADS / 32)
#define SU_GROUP 8  // chunks of SU_THREADS picks read before their ballots
#define SU_STAGE 4  // asks a thread stages per window
#define SU_WIN (SU_THREADS * SU_STAGE)
#define SU_WIN_LOG 10  // log2(SU_WIN)
#define SU_MAX_G 8  // batch rows walked in parallel
#define SU_MAX_LANES 65536  // the list's 16-bit lanes

// Dynamic shared memory: the list's lanes, then its rows.
__host__ __device__ static inline size_t su_rows_at(int b) {
  return ((size_t)2 * b + 15) / 16 * 16;
}
__host__ __device__ static inline size_t su_smem_bytes(int b) {
  return su_rows_at(b) + (size_t)b;
}

// Window k's entries that this thread stages: each group's entries
// segs[g] + k * sub + [0, sub), as {ask, batch row} and the row byte.
__device__ __forceinline__ void su_fetch(float4* pre, uint8_t* prow,
                                         const uint16_t* lanes,
                                         const uint8_t* rows,
                                         const float* __restrict__ req_f,
                                         const int* segs, const int* s_grp,
                                         const int* s_ent, int k, int sub,
                                         int groups, int per) {
#pragma unroll
  for (int s = 0; s < SU_STAGE; ++s) {
    if (s_grp[s] >= groups) continue;
    const int j = segs[s_grp[s]] + k * sub + s_ent[s];
    if (j >= segs[s_grp[s] + 1]) continue;
    const int lane = lanes[j];
    const float* q = req_f + (size_t)lane * REQ_FLOAT_WIDTH + RF_ASK;
    // A group of its own is one batch row.
    const int br = groups > 1 ? s_grp[s] : lane / per;
    pre[s] = make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2),
                         __int_as_float(br));
    prow[s] = rows[j];
  }
}

// Adds one staged entry's ask, closing the part when the batch row
// changes.
__device__ __forceinline__ void su_add1(const float4 v, int& cur, float& d0,
                                        float& d1, float& d2, float& p0,
                                        float& p1, float& p2) {
  const int br = __float_as_int(v.w);
  if (br != cur) {
    d0 = d0 + p0;
    d1 = d1 + p1;
    d2 = d2 + p2;
    p0 = p1 = p2 = 0.0f;
    cur = br;
  }
  p0 = p0 + v.x;
  p1 = p1 + v.y;
  p2 = p2 + v.z;
}

// Adds 16 staged entries of one row in order, closing the part when the
// batch row changes (batch rows only grow along the list, so a block
// whose last entry is of the current batch row is all of it).
__device__ __forceinline__ void su_add16(const float4 (&v)[16], int& cur,
                                         float& d0, float& d1, float& d2,
                                         float& p0, float& p1, float& p2) {
  if (__float_as_int(v[15].w) == cur) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      p0 = p0 + v[e].x;
      p1 = p1 + v[e].y;
      p2 = p2 + v[e].z;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) su_add1(v[e], cur, d0, d1, d2, p0, p1, p2);
}

__device__ __forceinline__ void su_load16(float4 (&v)[16], const float4* st) {
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = st[e];
}

// Adds a run of len staged entries (a multiple of 16) that all lie on this
// walker's row, 32 at a time: all 32 loads issued before the adds.
__device__ __forceinline__ void su_run(const float4* st, int len, int& cur,
                                       float& d0, float& d1, float& d2,
                                       float& p0, float& p1, float& p2) {
  int e = 0;
  for (; e + 32 <= len; e += 32) {
    float4 a[16], b[16];
    su_load16(a, st + e);
    su_load16(b, st + e + 16);
    su_add16(a, cur, d0, d1, d2, p0, p1, p2);
    su_add16(b, cur, d0, d1, d2, p0, p1, p2);
  }
  if (e < len) {
    float4 a[16];
    su_load16(a, st + e);
    su_add16(a, cur, d0, d1, d2, p0, p1, p2);
  }
}

__global__ void __launch_bounds__(SU_THREADS)
sharded_usage_kernel(const float* __restrict__ used,
                     const float* __restrict__ packed,
                     const float* __restrict__ req_f,
                     float* __restrict__ out, int n, int off, int b, int p,
                     int per, int span, int span_w, int groups, int vec) {
  extern __shared__ __align__(16) unsigned char su_smem[];
  uint16_t* list_lane = reinterpret_cast<uint16_t*>(su_smem);
  uint8_t* list_row = su_smem + su_rows_at(b);
  __shared__ int counts[SU_GROUP * SU_WARPS];
  __shared__ int starts[SU_GROUP * SU_WARPS];
  __shared__ int total;
  __shared__ int segs[SU_MAX_G + 1];
  __shared__ int run_row[SU_WIN / 16];
  __shared__ int uniform[SU_MAX_G];
  __shared__ float4 stage[SU_WIN];
  __shared__ __align__(16) uint8_t stage_row[SU_WIN];
  __shared__ __align__(16) float delta[SU_THREADS * 3];

  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const int lo = blockIdx.x * span;
  const int rows = min(span, n - lo);
  const int first = off + lo;  // the global row of the CTA's first row
  const size_t stride = (size_t)p * PACKED_WIDTH;
  // The CTA's rows of `used`, one float4 a thread, loaded now for the
  // last phase.
  const size_t at = (size_t)lo * 3;
  const int words = rows * 3;
  float4 u4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec && tid < words / 4)
    u4 = __ldg(reinterpret_cast<const float4*>(used + at) + tid);
  if (tid == 0) total = 0;

  // The ordered list of the lanes whose pick falls in [first, first+rows).
  for (int base = 0; base < b; base += SU_THREADS * SU_GROUP) {
    int r[SU_GROUP];
#pragma unroll
    for (int u = 0; u < SU_GROUP; ++u) {
      const int lane = base + u * SU_THREADS + tid;
      r[u] = -1;
      if (lane < b) {
        const int g = (int)__ldg(packed + (size_t)lane * stride);
        if (g >= first && g < first + rows) r[u] = g - first;
      }
    }
    unsigned m[SU_GROUP];
#pragma unroll
    for (int u = 0; u < SU_GROUP; ++u)
      m[u] = __ballot_sync(0xffffffffu, r[u] >= 0);
    if (lid == 0) {
#pragma unroll
      for (int u = 0; u < SU_GROUP; ++u)
        counts[u * SU_WARPS + warp] = __popc(m[u]);
    }
    __syncthreads();
    if (warp == 0) {
      // Exclusive prefix of the counts in (chunk, warp) order, which is
      // lane order; two counts a lane.
      const int c0 = counts[2 * lid], c1 = counts[2 * lid + 1];
      const int t0 = total;
      int s = c0 + c1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, s, d);
        if (lid >= d) s += x;
      }
      const int before = t0 + s - c0 - c1;
      starts[2 * lid] = before;
      starts[2 * lid + 1] = before + c0;
      __syncwarp();
      if (lid == 31) total = t0 + s;
    }
    __syncthreads();
    const unsigned below = (1u << lid) - 1u;
#pragma unroll
    for (int u = 0; u < SU_GROUP; ++u) {
      if (r[u] >= 0) {
        const int at = starts[u * SU_WARPS + warp] + __popc(m[u] & below);
        list_lane[at] = (uint16_t)(base + u * SU_THREADS + tid);
        list_row[at] = (uint8_t)r[u];
      }
    }
  }
  __syncthreads();
  const int count = total;
  if (count > 0) {
    // Each group's segment: the entries of lanes [g, g + 1) * (b / groups).
    if (tid <= groups) {
      const int want = tid * (b / groups);
      int a = 0, z = count;
      while (a < z) {
        const int mid = (a + z) >> 1;
        if ((int)list_lane[mid] < want) a = mid + 1;
        else z = mid;
      }
      segs[tid] = a;
    }
    __syncthreads();
    // A window stages each group's next `sub` entries at stage[g * sub]
    // (sub a power of two, at least 128).
    const int sub_log = SU_WIN_LOG - (32 - __clz(groups - 1));
    const int sub = 1 << sub_log;
    int windows = 0;
    for (int g = 0; g < groups; ++g)
      windows = max(windows, (segs[g + 1] - segs[g] + sub - 1) >> sub_log);
    // What this thread stages: stage index s * SU_THREADS + tid.
    int s_grp[SU_STAGE], s_ent[SU_STAGE];
#pragma unroll
    for (int s = 0; s < SU_STAGE; ++s) {
      const int idx = s * SU_THREADS + tid;
      s_grp[s] = idx >> sub_log;
      s_ent[s] = idx & (sub - 1);
    }
    const int grp = tid / span_w, row = tid - grp * span_w;
    const bool walker = grp < groups && row < rows;
    const int seg_len = walker ? segs[grp + 1] - segs[grp] : 0;

    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
    int cur = -1;
    float4 pre[SU_STAGE];
    uint8_t prow[SU_STAGE];
#pragma unroll
    for (int s = 0; s < SU_STAGE; ++s) {
      pre[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      prow[s] = 0;
    }
    su_fetch(pre, prow, list_lane, list_row, req_f, segs, s_grp, s_ent, 0, sub,
             groups, per);
    for (int k = 0; k < windows; ++k) {
      if (tid < groups) uniform[tid] = 1;
#pragma unroll
      for (int s = 0; s < SU_STAGE; ++s) {
        stage[s * SU_THREADS + tid] = pre[s];
        stage_row[s * SU_THREADS + tid] = prow[s];
      }
      __syncthreads();
      if (k + 1 < windows)
        su_fetch(pre, prow, list_lane, list_row, req_f, segs, s_grp, s_ent,
                 k + 1, sub, groups, per);
      // Each 16-entry block of a group's window whose entries all lie on
      // one row: that row, else -1; and whether the whole window lies on
      // the row of its first entry (every lane of a batch of identical
      // requests picks the same node).
      if (tid < groups * (sub >> 4)) {
        const int g = tid >> (sub_log - 4), blk = tid & ((sub >> 4) - 1);
        const int n =
            min(16, min(sub, segs[g + 1] - segs[g] - k * sub) - 16 * blk);
        const uint8_t* b8 = stage_row + g * sub + 16 * blk;
        const uint32_t* w = reinterpret_cast<const uint32_t*>(b8);
        const uint32_t w0 = w[0], r0 = w0 & 0xffu;
        const bool one = n == 16 && w0 == r0 * 0x01010101u && w[1] == w0 &&
                         w[2] == w0 && w[3] == w0;
        run_row[tid] = one ? (int)r0 : -1;
        const uint8_t first = stage_row[g * sub];
        bool same = one && r0 == first;
        if (n > 0 && n < 16) {
          same = true;
          for (int e = 0; e < n; ++e) same = same && b8[e] == first;
        }
        if (n > 0 && !same) uniform[g] = 0;
      }
      __syncthreads();
      // This walker's entries of the window: stage[grp * sub + [0, len)).
      const int len = max(0, min(sub, seg_len - k * sub));
      const float4* st = stage + grp * sub;
      const uint8_t* sr = stage_row + grp * sub;
      const int* runs = run_row + grp * (sub >> 4);
      if (len > 0 && uniform[grp]) {
        // One row: its walker adds them all, the others have none.
        if (row == sr[0]) {
          su_run(st, len & ~15, cur, d0, d1, d2, p0, p1, p2);
          for (int i = len & ~15; i < len; ++i)
            su_add1(st[i], cur, d0, d1, d2, p0, p1, p2);
        }
      } else {
        // Block by block: a run of blocks on this walker's row through
        // su_run, any other block entry by entry.
        for (int blk = 0; blk * 16 < len;) {
          if (runs[blk] == row) {
            int end = blk + 1;
            while (end * 16 < len && runs[end] == row) ++end;
            su_run(st + 16 * blk, 16 * (end - blk), cur, d0, d1, d2, p0, p1,
                   p2);
            blk = end;
            continue;
          }
          if (runs[blk] < 0) {
            const int stop = min(len, 16 * blk + 16);
            for (int i = 16 * blk; i < stop; ++i)
              if (sr[i] == row) su_add1(st[i], cur, d0, d1, d2, p0, p1, p2);
          }
          ++blk;
        }
      }
      __syncthreads();
    }

    // Each row's parts in batch-row order.
    delta[tid * 3] = d0 + p0;
    delta[tid * 3 + 1] = d1 + p1;
    delta[tid * 3 + 2] = d2 + p2;
    __syncthreads();
    float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f;
    if (tid < rows) {
      for (int g = 0; g < groups; ++g) {
        const int q = (g * span_w + tid) * 3;
        f0 = f0 + delta[q];
        f1 = f1 + delta[q + 1];
        f2 = f2 + delta[q + 2];
      }
    }
    __syncthreads();
    if (tid < rows) {
      delta[tid * 3] = f0;
      delta[tid * 3 + 1] = f1;
      delta[tid * 3 + 2] = f2;
    }
    __syncthreads();
  }

  // out = used + delta (+0.0 where no pick landed, as the plain version
  // adds it).
  if (vec) {
    if (tid < words / 4) {
      const float4 y = count > 0 ? reinterpret_cast<const float4*>(delta)[tid]
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      reinterpret_cast<float4*>(out + at)[tid] =
          make_float4(u4.x + y.x, u4.y + y.y, u4.z + y.z, u4.w + y.w);
    }
    const int i = words / 4 * 4 + tid;
    if (i < words)
      out[at + i] = __ldg(used + at + i) + (count > 0 ? delta[i] : 0.0f);
  } else {
    for (int i = tid; i < words; i += SU_THREADS)
      out[at + i] = __ldg(used + at + i) + (count > 0 ? delta[i] : 0.0f);
  }
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

// Rows a CTA of sharded_usage owns: about n / SMs, a multiple of 4 (so
// that every CTA's rows start on 16 bytes), at most SU_THREADS.
static int su_span(int n) {
  const int sms = nomad_sm_count();
  int span = ((n + sms - 1) / sms + 3) / 4 * 4;
  if (span > SU_THREADS) span = SU_THREADS;
  return span;
}

extern "C" int nomad_sharded_usage(const float* used, const float* packed,
                                   const float* req_f, float* out, int n,
                                   int row_offset, int b, int p, int n_batch,
                                   cudaStream_t stream) {
  if (n <= 0 || b <= 0 || b > SU_MAX_LANES || p < 1 || row_offset < 0 ||
      row_offset > INT_MAX - n || n_batch < 1 || b % n_batch)
    return (int)cudaErrorInvalidValue;
  const size_t smem = su_smem_bytes(b);
  if (smem > 48 * 1024) {
    static bool attr_set[NOMAD_MAX_DEVICES];
    const cudaError_t e = nomad_smem_once(attr_set, sharded_usage_kernel,
                                          (int)su_smem_bytes(SU_MAX_LANES));
    if (e != cudaSuccess) return (int)e;
  }
  const int span = su_span(n);
  // Warp-aligned groups of row threads, one a batch row, where they fit.
  const int span_w = (span + 31) / 32 * 32;
  const int groups =
      n_batch <= SU_MAX_G && n_batch * span_w <= SU_THREADS ? n_batch : 1;
  const int vec = ((reinterpret_cast<uintptr_t>(used) |
                    reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  sharded_usage_kernel<<<(n + span - 1) / span, SU_THREADS, smem, stream>>>(
      used, packed, req_f, out, n, row_offset, b, p, b / n_batch, span,
      span_w, groups, vec);
  return (int)cudaGetLastError();
}
