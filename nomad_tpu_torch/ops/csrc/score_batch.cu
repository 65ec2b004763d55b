// score_batch — B independent evaluations, each an argmax over every node.
//
// Replaces nomad_tpu/ops/kernels.py:score_batch (:627): the vmapped
// _score_and_pick (:601) over score_nodes (:525), the batched-eval
// program bench.py's kernel phase and __graft_entry__.entry() run.  Every
// lane scores all N rows against the shared usage `used` (no carry, no
// deltas, every lane live) and keeps the best row: highest score, lowest
// row on ties (jnp.argmax).  A lane where nothing fits reads row -1 and
// zero score, binpack and preemption; its three node counters (evaluated,
// filtered, exhausted) are counted over all rows either way.
//
// What bounds it on an H100: the bytes of the per-lane operands, 6 bytes
// a lane and node (tg_counts 4, penalties 1, host_masks 1): about 252 MB
// at B=4096 and N=10240, 0.075 ms at 3.35 TB/s.  There is no matrix
// product here: nothing runs on the tensor cores.  One block per lane (the
// first design) re-read every node column it needed from L2 for every
// lane, 4-byte reads at the 128-byte row stride of the attribute tables,
// and took 1.4 ms.  This design takes 0.59 ms (PERF.md): streaming the
// operands alone runs at about 2.2 TB/s, the node-column gathers and the
// per-node scoring (long chains of dependent shared-memory reads) take
// the rest.
//
// Design: node tiles shared by lane tiles.
// * A CTA of 8 warps takes a tile of LT lanes (16 for large batches, 8
//   for small ones) and a span of the node axis, walked in tiles of 128
//   rows.  Each tile lands in a ring of four stages in shared memory by
//   cp.async (three tiles load while one is scored): the node columns its
//   lanes refer to (each referenced slot's attr_hash, and attr_num or
//   attr_ver where an op compares them, at most 8; then class_id, totals,
//   used, eligible), gathered once for all of the CTA's lanes, and every
//   lane's tg_counts, penalties and host masks for the tile, by 16-byte
//   copies.  Columns past 8 and the rarely read ones (devices, ports,
//   prio_used) come from the matrix.
// * Thread t of a warp scores the four consecutive nodes 4t..4t+3 for one
//   lane at a time: the lane's request is the same for the whole warp (its
//   loops and branches do not diverge), its operands are one 16-byte and
//   two 4-byte reads, and the node columns are stored permuted (node
//   4t + j at 32j + t) so a warp's reads hit 32 distinct banks.  Warps take
//   the tile's lanes as they finish (lanes differ in cost); each thread's
//   running best and counters per lane stay in shared memory.
// * Lane-level work is done once per lane (scoring.cuh lane_setup): the
//   active slots in order, the ops decoded, and each spread stanza's score
//   by value in a 32-slot open-addressing table of the lane's known value
//   hashes (a node does one probe, not the 16-value loop).
// * Loop widths are template parameters (scoring.cuh Widths); the entry
//   picks the instantiation that covers the batch's Features.
// * Small batches split the node axis over a thread-block cluster of S
//   CTAs (S up to 8) so B=256 fills the card too; each CTA reduces its
//   span, and CTA 0 reads the others' partial (best, counters) through
//   distributed shared memory and writes the lane's result.  The best is
//   a total order (score, then lowest row) and the counters integer sums,
//   so the result does not depend on the order.
//
// Output: rows, score bits, binpack bits and the three counters as a
// (6, B) int32 array and the preemption flags as (B,) bytes of 0 or 1 —
// the BatchScoreResult fields in their own types, so the wrapper converts
// nothing.
//
// Numerics: scoring.cuh's, built with -fmad=false and no fast math, so the
// kernel rounds exactly as the plain PyTorch version
// (ops/kernels.py:score_batch_plain).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "feasibility.cuh"
#include "layout.cuh"
#include "per_device.cuh"
#include "scoring.cuh"

namespace cg = cooperative_groups;

#define SB_THREADS 256
#define SB_WARPS (SB_THREADS / 32)
#define SB_TILE 128       // node rows per tile: 32 threads x 4 nodes
#define SB_MAX_COLS 8     // staged attribute columns
#define SB_MAX_SLOTS 64   // attribute slots the column map covers
#define SB_HSLOTS 32      // open-addressing slots of a stanza's value table
#define SB_MAX_K 128      // class eligibility bytes staged per lane
#define SB_MAX_CLUSTER 8
#define SB_STAGES 4       // tiles in the ring: three load while one is scored

// CTAs an SM each instantiation's registers must allow: the bench's widths
// fit three at <= 85 registers; the full widths need more and take two
// (shared memory allows two at 16 lanes a CTA either way).
template <class W>
struct SBOcc {
  static constexpr int value = W::CW <= WidthsBench::CW && !W::PRE ? 3 : 2;
};

struct SBParams {
  NodeTables m;
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
  int32_t* out_i;              // (6, B)
  uint8_t* out_pre;            // (B,)
  int n, b, k, lt, span;
  RunWidths rw;
};

// A stanza's value table as open addressing: key = value hash (0 empty),
// the score of a node holding it; plus the two scores for a value the
// table lacks and for no value.
struct SprHash {
  int key[SB_HSLOTS];
  float score[SB_HSLOTS];
  float nomatch, novalue;
};

template <class W>
struct SBLane {
  LaneSetup<W> L;
  SprHash h[AtLeast1<W::SW>::value];
  uint8_t ce[SB_MAX_K];  // class eligibility, where K <= SB_MAX_K
};

// A lane's result over the CTA's span.
struct Partial {
  Best best;
  int c0, c1, c2;
};

__device__ __forceinline__ unsigned hslot(int h) {
  return ((unsigned)h * 2654435761u) >> 27;  // 32 slots
}

// One stage of the tile ring: the tile's node columns and the per-lane
// operands of every lane of the block.  Thread t of a warp scores the four
// consecutive nodes 4t..4t+3, so it reads its per-lane operands as one
// 16-byte word of tg_counts and one 4-byte word of each byte operand; the
// 4-byte node columns are stored permuted, node 4t + j at 32j + t, so a
// warp's reads of them hit 32 distinct banks.  The eligible bytes and the
// per-lane operands stay in node order.
struct StageView {
  int32_t* col;   // [SB_MAX_COLS][T] attr_hash / attr_num / attr_ver, permuted
  float* tot;     // [3][T] permuted
  float* use;     // [3][T] permuted
  int32_t* cls;   // [T] permuted
  int32_t* tg;    // [LT][T]
  uint8_t* elig;  // [T]
  uint8_t* pen;   // [LT][T]
  uint8_t* host;  // [LT][T]
};

__host__ __device__ __forceinline__ size_t stage_bytes(int lt) {
  return (size_t)SB_TILE * (SB_MAX_COLS * 4 + 3 * 4 + 3 * 4 + 4) +
         (size_t)lt * SB_TILE * 4 + SB_TILE + (size_t)lt * SB_TILE * 2;
}

__device__ __forceinline__ StageView stage_view(unsigned char* base, int lt) {
  StageView s;
  s.col = (int32_t*)base;
  s.tot = (float*)(s.col + SB_MAX_COLS * SB_TILE);
  s.use = s.tot + 3 * SB_TILE;
  s.cls = (int32_t*)(s.use + 3 * SB_TILE);
  s.tg = s.cls + SB_TILE;
  s.elig = (uint8_t*)(s.tg + lt * SB_TILE);
  s.pen = s.elig + SB_TILE;
  s.host = s.pen + lt * SB_TILE;
  return s;
}

// Position of tile node q in the permuted 4-byte columns.
__device__ __forceinline__ int perm(int q) { return ((q & 3) << 5) | (q >> 2); }

// Node columns of a staged tile; unstaged ones from the matrix.  `p` is
// the node's permuted position, `i` its matrix row.
struct StagedNodes {
  const NodeTables* m;
  const int32_t* col;
  const int32_t* cls_;
  const uint8_t* elig_;
  int t0;  // the tile's first row
  __device__ __forceinline__ bool elig(int, int i) const {
    return elig_[i - t0] != 0;
  }
  __device__ __forceinline__ int cls(int p, int) const { return cls_[p]; }
  __device__ __forceinline__ int hash(int p, int i, int c, int slot) const {
    return c >= 0 ? col[c * SB_TILE + p] : m->attr_hash[(size_t)i * m->a + slot];
  }
  __device__ __forceinline__ float val(int p, int i, int c, int slot,
                                       bool ver) const {
    return c >= 0 ? __int_as_float(col[c * SB_TILE + p])
                  : (ver ? m->attr_ver : m->attr_num)[(size_t)i * m->a + slot];
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Dynamic shared memory: the lanes, each thread's running result per lane
// (7 words), the lanes' partials, and the ring of SB_STAGES tiles.
__host__ __device__ __forceinline__ size_t sb_smem_bytes(size_t lane_bytes,
                                                         int lt) {
  return align16(lane_bytes * lt) + align16((size_t)7 * 4 * 32 * lt) +
         align16(sizeof(Partial) * lt) + SB_STAGES * align16(stage_bytes(lt));
}

// Load tile [t0, t0 + nt) into a stage: the staged attribute columns,
// totals, used and class ids gathered by 4-byte cp.async into their
// permuted positions; the lanes' tg_counts, penalties and host masks and
// the eligible bytes by 16-byte cp.async where `vec` (every row and tile
// start 16-byte aligned), else a word or a byte at a time.
__device__ __forceinline__ void load_tile(const SBParams& P,
                                          const StageView& st,
                                          const int* col_src, int ncols,
                                          int lane0, int nl, int t0, int nt,
                                          bool vec) {
  const int tid = threadIdx.x;
  const int A = P.m.a;
  const size_t N = (size_t)P.n;
  for (int c = 0; c < ncols; ++c) {
    const int src = col_src[c];  // kind * SB_MAX_SLOTS + slot
    const int kind = src / SB_MAX_SLOTS, slot = src % SB_MAX_SLOTS;
    const int32_t* base =
        kind == 0 ? P.m.attr_hash
                  : (const int32_t*)(kind == 1 ? P.m.attr_num : P.m.attr_ver);
    for (int q = tid; q < nt; q += SB_THREADS)
      cp_async4(&st.col[c * SB_TILE + perm(q)],
                base + (size_t)(t0 + q) * A + slot);
  }
  for (int q = tid; q < nt; q += SB_THREADS) {
    const size_t i = (size_t)(t0 + q);
    const int p = perm(q);
    for (int d = 0; d < 3; ++d) {
      cp_async4(&st.tot[d * SB_TILE + p], P.totals + i * 3 + d);
      cp_async4(&st.use[d * SB_TILE + p], P.used + i * 3 + d);
    }
    cp_async4(&st.cls[p], P.m.class_id + i);
  }
  if (vec) {  // nt is a multiple of 16
    const int w4 = nt / 4, w16 = nt / 16;
    for (int e = tid; e < nl * w4; e += SB_THREADS) {
      const int l = e / w4, w = e - l * w4;
      cp_async16(&st.tg[l * SB_TILE + 4 * w],
                 P.tg_counts + (lane0 + l) * N + t0 + 4 * w);
    }
    for (int e = tid; e < nl * w16; e += SB_THREADS) {
      const int l = e / w16, w = e - l * w16;
      const size_t at = (lane0 + l) * N + t0 + 16 * w;
      cp_async16(&st.pen[l * SB_TILE + 16 * w], P.penalties + at);
      cp_async16(&st.host[l * SB_TILE + 16 * w], P.host_masks + at);
    }
    for (int w = tid; w < w16; w += SB_THREADS)
      cp_async16(&st.elig[16 * w], P.m.eligible + t0 + 16 * w);
  } else {
    for (int e = tid; e < nl * nt; e += SB_THREADS) {
      const int l = e / nt, q = e - l * nt;
      const size_t at = (lane0 + l) * N + t0 + q;
      cp_async4(&st.tg[l * SB_TILE + q], P.tg_counts + at);
      st.pen[l * SB_TILE + q] = P.penalties[at];
      st.host[l * SB_TILE + q] = P.host_masks[at];
    }
    for (int q = tid; q < nt; q += SB_THREADS)
      st.elig[q] = P.m.eligible[t0 + q];
  }
  cp_async_commit();
}

// Mark the columns lane L refers to (kind 0 hash, 1 num, 2 ver).
template <class W>
__device__ void mark_columns(const LaneSetup<W>& L, int* need) {
  if (L.dc_on) need[0] = 1;
  for (int c = 0; c < L.n_c; ++c) {
    const Pred& p = L.c[c];
    if (p.slot < SB_MAX_SLOTS) {
      need[p.slot] = 1;
      if (p.flags & PF_NUM)
        need[((p.flags & PF_VER) ? 2 : 1) * SB_MAX_SLOTS + p.slot] = 1;
    }
  }
  for (int j = 0; j < L.n_a; ++j) {
    const Pred& p = L.a[j];
    if (p.slot >= 0 && p.slot < SB_MAX_SLOTS) {
      need[p.slot] = 1;
      if (p.flags & PF_NUM)
        need[((p.flags & PF_VER) ? 2 : 1) * SB_MAX_SLOTS + p.slot] = 1;
    }
  }
  for (int s = 0; s < W::SW; ++s)
    if (L.s_on[s] && L.s_slot[s] < SB_MAX_SLOTS) need[L.s_slot[s]] = 1;
}

__device__ __forceinline__ int col_of(const int* colmap, int kind, int slot) {
  return (slot >= 0 && slot < SB_MAX_SLOTS) ? colmap[kind * SB_MAX_SLOTS + slot]
                                            : -1;
}

template <class W>
__device__ void assign_columns(LaneSetup<W>& L, const int* colmap) {
  L.dc_col = col_of(colmap, 0, 0);
  for (int c = 0; c < L.n_c; ++c) {
    Pred& p = L.c[c];
    p.hcol = col_of(colmap, 0, p.slot);
    p.vcol = col_of(colmap, (p.flags & PF_VER) ? 2 : 1, p.slot);
  }
  for (int j = 0; j < L.n_a; ++j) {
    Pred& p = L.a[j];
    p.hcol = col_of(colmap, 0, p.slot);
    p.vcol = col_of(colmap, (p.flags & PF_VER) ? 2 : 1, p.slot);
  }
  for (int s = 0; s < W::SW; ++s) L.s_col[s] = col_of(colmap, 0, L.s_slot[s]);
}

// Stanza s's value table of one lane (its request's known values and its
// counts) as open addressing, each key with the score of a node holding
// it.
__device__ void build_spread_hash(SprHash& H, int s, const int* ri,
                                  const float* rf, const float* s_cnt) {
  const int* s_hash = ri + RI_S_VALUE_HASH;
  float mn[MAX_S], mx[MAX_S];
  int any[MAX_S];
  even_spread_stats(s_hash, s_cnt, mn, mx, any);
  for (int j = 0; j < SB_HSLOTS; ++j) H.key[j] = 0;
  for (int v = 0; v < MAX_V; ++v) {
    const int h = s_hash[s * MAX_V + v];
    if (h == 0) continue;
    unsigned j = hslot(h);
    while (H.key[j] != 0 && H.key[j] != h) j = (j + 1) & (SB_HSLOTS - 1);
    if (H.key[j] == 0) {
      H.key[j] = h;
      H.score[j] = spread_entry_score(v, s, ri, rf, s_hash, s_cnt, mn, mx, any);
    }
  }
  H.nomatch = spread_entry_score(SPR_NOMATCH, s, ri, rf, s_hash, s_cnt, mn,
                                 mx, any);
  H.novalue = spread_entry_score(SPR_NOVALUE, s, ri, rf, s_hash, s_cnt, mn,
                                 mx, any);
}

__device__ __forceinline__ float spread_lookup(const SprHash& H, int nvalue) {
  if (nvalue == 0) return H.novalue;
  unsigned j = hslot(nvalue);
  while (true) {
    const int key = H.key[j];
    if (key == nvalue) return H.score[j];
    if (key == 0) return H.nomatch;
    j = (j + 1) & (SB_HSLOTS - 1);
  }
}

// Score node i (permuted position p) for one lane into a running best and
// the three counters.
template <class W>
__device__ __forceinline__ void score_pair(const StagedNodes& S,
                                           const StageView& st,
                                           const SBLane<W>& LN,
                                           const SBParams& P,
                                           const uint8_t* class_elig, int p,
                                           int i, int tg, bool pen_app,
                                           bool host, Best& best, int& c0,
                                           int& c1, int& c2) {
  const LaneSetup<W>& L = LN.L;
  bool elig, feas;
  feasible_k<W, 1>(S, &p, &i, L, class_elig, P.k, &host, &feas, &elig);
  feas = feas && !(L.distinct && tg > 0);
  c0 += feas;
  c1 += !feas && elig;
  if (!feas) return;
  const FitParts f = fit_parts<W>(
      L, P.prio_used, i, st.use[p], st.use[SB_TILE + p],
      st.use[2 * SB_TILE + p], st.tot[p], st.tot[SB_TILE + p],
      st.tot[2 * SB_TILE + p]);
  c2 += !f.fits_all;
  if (!f.fits_all) return;
  bool aa_app, aff_app;
  const float aa = anti_affinity(tg, L.desired, aa_app);
  const float pen = pen_app ? -1.0f : 0.0f;
  const float aff = affinity<W>(S, p, i, L, aff_app);
  float spr_total = 0.0f;
#pragma unroll
  for (int s = 0; s < W::SW; ++s)
    if (L.s_on[s])
      spr_total = spr_total +
                  spread_lookup(LN.h[s], S.hash(p, i, L.s_col[s], L.s_slot[s]));
  const float fin = score_of(partial_sum(f.binpack, aa, pen, aff), spr_total,
                             L.has_spread, f.pre,
                             aa_app + pen_app + aff_app + f.needs_pre);
  if (better(fin, i, best.val, best.row)) {
    best.val = fin;
    best.row = i;
    best.bin = f.binpack;
    best.pre = f.needs_pre;
  }
}

template <class W>
__global__ void __launch_bounds__(SB_THREADS, SBOcc<W>::value)
score_batch_kernel(const __grid_constant__ SBParams P) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const int lt = P.lt;
  const int lane0 = blockIdx.y * lt;
  const int nl = min(lt, P.b - lane0);
  const int N = P.n;
  const int begin = rank * P.span;
  const int end = min(N, begin + P.span);
  const bool vec =
      (N & 15) == 0 && (((uintptr_t)P.tg_counts | (uintptr_t)P.penalties |
                          (uintptr_t)P.host_masks | (uintptr_t)P.m.eligible) &
                         15) == 0;

  extern __shared__ __align__(16) unsigned char smem[];
  SBLane<W>* lanes = (SBLane<W>*)smem;
  unsigned char* at = smem + align16(sizeof(SBLane<W>) * lt);
  float* run_val = (float*)at;          // [lt][32] each
  int* run_row = (int*)(run_val + 32 * lt);
  float* run_bin = (float*)(run_row + 32 * lt);
  int* run_pre = (int*)(run_bin + 32 * lt);
  int* run_c0 = run_pre + 32 * lt;
  int* run_c1 = run_c0 + 32 * lt;
  int* run_c2 = run_c1 + 32 * lt;
  at += align16((size_t)7 * 4 * 32 * lt);
  Partial* parts = (Partial*)at;
  unsigned char* ring = at + align16(sizeof(Partial) * lt);
  const size_t stage_sz = align16(stage_bytes(lt));

  __shared__ int need[3 * SB_MAX_SLOTS];
  __shared__ int colmap[3 * SB_MAX_SLOTS];
  __shared__ int col_src[SB_MAX_COLS];
  __shared__ int ncols;
  __shared__ int grab[2];

  for (int j = tid; j < 3 * SB_MAX_SLOTS; j += SB_THREADS) need[j] = 0;
  for (int j = tid; j < 32 * lt; j += SB_THREADS) {
    run_val[j] = -CUDART_INF_F;
    run_row[j] = 0x7fffffff;
    run_bin[j] = 0.0f;
    run_pre[j] = 0;
    run_c0[j] = run_c1[j] = run_c2[j] = 0;
  }
  if (tid < 2) grab[tid] = 0;

  // Lane setup: warp w digests lanes w, w + 8, ...; the packed requests
  // pass through the (not yet used) tile ring.
  {
    int* s_ri = (int*)ring + warp * (REQ_INT_WIDTH + REQ_FLOAT_WIDTH +
                                     MAX_S * MAX_V);
    float* s_rf = (float*)(s_ri + REQ_INT_WIDTH);
    float* s_cnt = s_rf + REQ_FLOAT_WIDTH;
    for (int l = warp; l < nl; l += SB_WARPS) {
      const size_t lane = (size_t)(lane0 + l);
      for (int j = lid; j < REQ_INT_WIDTH; j += 32)
        s_ri[j] = P.req_i[lane * REQ_INT_WIDTH + j];
      for (int j = lid; j < REQ_FLOAT_WIDTH; j += 32)
        s_rf[j] = P.req_f[lane * REQ_FLOAT_WIDTH + j];
      for (int j = lid; j < MAX_S * MAX_V; j += 32)
        s_cnt[j] = P.spread_counts[lane * MAX_S * MAX_V + j];
      if (P.k <= SB_MAX_K)
        for (int j = lid; j < P.k; j += 32)
          lanes[l].ce[j] = P.class_eligs[lane * P.k + j];
      __syncwarp();
      if (lid == 0) lane_setup<W>(lanes[l].L, s_ri, s_rf, P.rw, P.m.a);
      __syncwarp();
      if (lid < W::SW && lanes[l].L.s_on[lid])
        build_spread_hash(lanes[l].h[lid], lid, s_ri, s_rf, s_cnt);
      __syncwarp();
    }
  }
  __syncthreads();

  // The block's staged columns: the union of what its lanes refer to, in
  // slot order, hashes first, at most SB_MAX_COLS.
  if (tid < nl) mark_columns<W>(lanes[tid].L, need);
  __syncthreads();
  if (warp == 0) {
    int nc = 0;
    for (int j0 = 0; j0 < 3 * SB_MAX_SLOTS; j0 += 32) {
      const int j = j0 + lid;
      const bool want = need[j] && j % SB_MAX_SLOTS < P.m.a;
      const unsigned bal = __ballot_sync(0xffffffffu, want);
      const int c = nc + __popc(bal & ((1u << lid) - 1u));
      colmap[j] = (want && c < SB_MAX_COLS) ? c : -1;
      if (want && c < SB_MAX_COLS) col_src[c] = j;
      nc += __popc(bal);
    }
    if (lid == 0) ncols = min(nc, SB_MAX_COLS);
  }
  __syncthreads();
  if (tid < nl) assign_columns<W>(lanes[tid].L, colmap);

  const int n_tiles = end > begin ? (end - begin + SB_TILE - 1) / SB_TILE : 0;
  // Prologue: the first SB_STAGES - 1 tiles in flight (an empty group for a
  // missing tile keeps the group count uniform).
  for (int t = 0; t < SB_STAGES - 1; ++t) {
    if (t < n_tiles) {
      const int t0 = begin + t * SB_TILE;
      load_tile(P, stage_view(ring + t * stage_sz, lt), col_src, ncols, lane0,
                nl, t0, min(SB_TILE, end - t0), vec);
    } else {
      cp_async_commit();
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = begin + t * SB_TILE;
    const int nt = min(SB_TILE, end - t0);
    const int tn = t + SB_STAGES - 1;  // the tile to start loading now
    if (tn < n_tiles) {
      const int tn0 = begin + tn * SB_TILE;
      load_tile(P, stage_view(ring + (tn % SB_STAGES) * stage_sz, lt), col_src,
                ncols, lane0, nl, tn0, min(SB_TILE, end - tn0), vec);
    } else {
      cp_async_commit();
    }
    cp_async_wait<SB_STAGES - 1>();  // tile t has landed
    __syncthreads();

    const StageView st = stage_view(ring + (t % SB_STAGES) * stage_sz, lt);
    StagedNodes S;
    S.m = &P.m;
    S.col = st.col;
    S.cls_ = st.cls;
    S.elig_ = st.elig;
    S.t0 = t0;
    const int qb = 4 * lid;
    const int cnt = min(4, nt - qb);
    // Warps take the tile's lanes in turn as they finish (lanes differ in
    // cost); each thread's running result per lane lives in shared memory.
    while (true) {
      int l = 0;
      if (lid == 0) l = atomicAdd(&grab[t & 1], 1);
      l = __shfl_sync(0xffffffffu, l, 0);
      if (l >= nl) break;
      const SBLane<W>& LN = lanes[l];
      const uint8_t* class_elig =
          P.k <= SB_MAX_K ? LN.ce : P.class_eligs + (size_t)(lane0 + l) * P.k;
      const int4 tg = *(const int4*)&st.tg[l * SB_TILE + qb];
      const unsigned pw = *(const unsigned*)&st.pen[l * SB_TILE + qb];
      const unsigned hw = *(const unsigned*)&st.host[l * SB_TILE + qb];
      const int r = l * 32 + lid;
      Best best = {run_val[r], run_row[r], run_bin[r], run_pre[r]};
      int c0 = run_c0[r], c1 = run_c1[r], c2 = run_c2[r];
      const int tg4[4] = {tg.x, tg.y, tg.z, tg.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < cnt)
          score_pair<W>(S, st, LN, P, class_elig, 32 * j + lid, t0 + qb + j,
                        tg4[j], ((pw >> (8 * j)) & 0xffu) != 0,
                        ((hw >> (8 * j)) & 0xffu) != 0, best, c0, c1, c2);
      run_val[r] = best.val;
      run_row[r] = best.row;
      run_bin[r] = best.bin;
      run_pre[r] = best.pre;
      run_c0[r] = c0;
      run_c1[r] = c1;
      run_c2[r] = c2;
    }
    __syncthreads();  // the next iteration loads into this tile's stage
    if (tid == 0) grab[t & 1] = 0;
  }

  // Each lane's result over the span: its 32 threads' running results.
  for (int l = warp; l < nl; l += SB_WARPS) {
    const int r = l * 32 + lid;
    Best best = {run_val[r], run_row[r], run_bin[r], run_pre[r]};
    int c0 = run_c0[r], c1 = run_c1[r], c2 = run_c2[r];
    warp_best(best, c0, c1, c2);
    if (lid == 0) parts[l] = {best, c0, c1, c2};
  }
  // CTA 0 of the cluster merges the others' partials (distributed shared
  // memory) and writes each lane's result.
  if (n_ranks > 1) cluster.sync();
  else __syncthreads();
  if (rank == 0 && tid < nl) {
    Partial acc = parts[tid];
    for (int r = 1; r < n_ranks; ++r) {
      const Partial o = *cluster.map_shared_rank(&parts[tid], r);
      if (better(o.best.val, o.best.row, acc.best.val, acc.best.row))
        acc.best = o.best;
      acc.c0 += o.c0;
      acc.c1 += o.c1;
      acc.c2 += o.c2;
    }
    const int lane = lane0 + tid, B = P.b;
    const bool ok = acc.best.val > NEG_INF_F / 2.0f;
    P.out_i[lane] = ok ? acc.best.row : -1;
    P.out_i[B + lane] = __float_as_int(ok ? acc.best.val : 0.0f);
    P.out_i[2 * B + lane] = __float_as_int(ok ? acc.best.bin : 0.0f);
    P.out_i[3 * B + lane] = acc.c0;
    P.out_i[4 * B + lane] = acc.c1;
    P.out_i[5 * B + lane] = acc.c2;
    P.out_pre[lane] = (ok && acc.best.pre) ? 1 : 0;
  }
  if (n_ranks > 1) cluster.sync();  // keep this CTA's partials alive
}

// Launch shape for a batch: lanes per block, cluster size (node-axis
// split) and the node span of each CTA.
struct SBShape {
  int lt, s, span, tiles;
  size_t smem;
};

static int sm_count() { return nomad_sm_count(); }

static size_t lane_bytes(int tier) {
  return tier == 0 ? sizeof(SBLane<WidthsBench>) : sizeof(SBLane<WidthsFull>);
}

static SBShape sb_shape(int n, int b, int tier) {
  SBShape sh;
  sh.lt = b >= 1024 ? 16 : 8;
  sh.tiles = (b + sh.lt - 1) / sh.lt;
  // Split the node axis until the grid fills the card at the CTAs an SM
  // the instantiation allows.
  const int target =
      (tier == 0 ? SBOcc<WidthsBench>::value : SBOcc<WidthsFull>::value) *
      sm_count();
  int s = target / sh.tiles;
  if (s < 1) s = 1;
  if (s > SB_MAX_CLUSTER) s = SB_MAX_CLUSTER;
  const int max_s = (n + SB_TILE - 1) / SB_TILE;
  if (s > max_s) s = max_s;
  sh.s = s;
  const int per = (n + s - 1) / s;
  sh.span = (per + SB_TILE - 1) / SB_TILE * SB_TILE;
  sh.smem = sb_smem_bytes(lane_bytes(tier), sh.lt);
  return sh;
}

template <class W>
static int launch(const SBParams& P, const SBShape& sh, cudaStream_t stream) {
  static bool attr_set[NOMAD_MAX_DEVICES];
  {
    const cudaError_t e =
        nomad_smem_once(attr_set, score_batch_kernel<W>,
                        (int)sb_smem_bytes(sizeof(SBLane<W>), 16));
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.s, sh.tiles, 1);
  cfg.blockDim = dim3(SB_THREADS, 1, 1);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, score_batch_kernel<W>, P);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch shape the entry would use: {cluster size, lanes per block,
// node tile, dynamic shared memory bytes, instantiation tier}.
extern "C" int nomad_score_batch_shape(int n, int b, int c_width, int a_width,
                                       int s_width, int preempt, int ports,
                                       int* out) {
  const RunWidths rw = {c_width, a_width, s_width, preempt, ports};
  const int tier = widths_tier(rw);
  const SBShape sh = sb_shape(n, b, tier);
  out[0] = sh.s;
  out[1] = sh.lt;
  out[2] = SB_TILE;
  out[3] = (int)sh.smem;
  out[4] = tier;
  return 5;
}

extern "C" int nomad_score_batch(
    const float* totals, const float* used, const uint8_t* eligible,
    const int32_t* attr_hash, const float* attr_num, const float* attr_ver,
    const int32_t* class_id, const int32_t* dev_total, const int32_t* dev_used,
    const float* prio_used, const int32_t* port_words, const int32_t* dyn_used,
    const int32_t* tg_counts, const float* spread_counts,
    const uint8_t* penalties, const int32_t* req_i, const float* req_f,
    const uint8_t* class_eligs, const uint8_t* host_masks, int32_t* out_i,
    uint8_t* out_pre, int n, int a, int w, int b, int k, int c_width,
    int a_width, int s_width, int preempt, int ports, cudaStream_t stream) {
  if (c_width > MAX_C || a_width > MAX_A || s_width > MAX_S || n <= 0 ||
      b <= 0 || k <= 0 || a <= 0 || c_width < 0 || a_width < 0 || s_width < 0)
    return (int)cudaErrorInvalidValue;
  SBParams P;
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
  P.out_i = out_i;
  P.out_pre = out_pre;
  P.n = n;
  P.b = b;
  P.k = k;
  P.rw = {c_width, a_width, s_width, preempt, ports};
  const int tier = widths_tier(P.rw);
  const SBShape sh = sb_shape(n, b, tier);
  P.lt = sh.lt;
  P.span = sh.span;
  if (tier == 0) return launch<WidthsBench>(P, sh, stream);
  return launch<WidthsFull>(P, sh, stream);
}
