// fused_place — B placement scans in one launch.
//
// Replaces the per-lane part of the JAX megakernel
// nomad_tpu/ops/kernels.py:_fused_place_batch_impl (the vmapped
// _place_scan over score_nodes, kernels.py:521 and :707), the staged
// _place_batch_impl (:817, every lane live) and, at B=1 with a dense base
// usage and no lane deltas, place_task_group (:774).  The cross-lane
// AllocsFit verify column is allocs_fit_verify.cu.
//
// What bounds it on an H100: neither the bytes nor the arithmetic (the
// function needs a few MB and ~1e7 float operations at B=64, N=10240,
// P=16), but the P dependent steps of each lane: every step ends in an
// argmax over the lane's nodes that the next step needs.  The first design
// rescored every node with the full score at every step, one block per
// lane on 64 of 132 SMs (1.27-1.76 ms, PERF.md); this one takes 0.11-0.13
// ms, a third of it step 0 and the rest 16 steps of about 4 us, most of
// which are barriers and the winner's rescoring.
//
// Design: a hoisted scan over a thread-block cluster.
// * A lane runs on a cluster of C CTAs of 512 threads (C from 2 to 8:
//   about one CTA an SM; more where the lane's state needs more shared
//   memory).  CTA r owns a span of the node axis.
// * Step 0 scores each owned node once with the full score (scoring.cuh),
//   four nodes a thread at a time with their feasibility checks together
//   (their loads overlap): feasibility, fit, preemption, anti-affinity,
//   penalty, affinity.  A node that is feasible and fits is a candidate
//   and keeps its state: the partial sum ((binpack + anti-affinity) +
//   penalty) + affinity in the plain version's order, binpack, affinity,
//   the preemption component, the appended and feasibility bits, and per
//   spread stanza its value hash and the index of its value in the lane's
//   value table.  Nodes that are not candidates can only stay so (usage
//   only grows at a winner), so the three node counters are counted once
//   and then adjusted at each winner.
// * Each later step needs only the spread term, which changes for every
//   node but only through the lane's value table: the step scores the
//   table's entries (scoring.cuh spread_entry_score) and each candidate
//   looks its entry up, adds it and the preemption component to its
//   partial sum, divides by its count, and the CTA takes its argmax.
// * The CTAs exchange (score, row, binpack, preemption, counters) through
//   distributed shared memory after a cluster barrier; each picks the same
//   winner (highest score, lowest row), CTA 0 writes the step's row, the
//   owner CTA applies the ask to the winner's usage and rescores that one
//   node (its tg count, fit, preemption, anti-affinity, distinct_hosts)
//   while, in another warp, every CTA applies the winner's spread values
//   to its copy of the tables (apply_spread_values, kernels.py:677); a
//   value new to a table moves only the candidates holding that hash off
//   "no match".
// * Usage is kept only where it differs from `used`: the lane's delta rows
//   (summed in delta order, as .at[].add does; at most MAX_LANE_DELTAS)
//   and its placed rows, in a small table in shared memory.
// * Candidate state is 22-31 bytes a node; it lives in shared memory past
//   48 KB (cudaFuncSetAttribute) when a CTA's span fits the budget, else
//   in a per-CTA device-memory scratch the wrapper allocates, in the same
//   kernel.
// * Loop widths are template parameters (scoring.cuh Widths); the entry
//   picks the instantiation that covers the batch's Features.
//
// Numerics: built without --use_fast_math and with -fmad=false, so exp2f,
// expf and division are the IEEE/libdevice versions and no a*b+c is fused:
// the kernel rounds like the plain PyTorch version on the card.  x/18 is
// computed as x * float(1/18), as XLA and the plain version do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "feasibility.cuh"
#include "layout.cuh"
#include "scoring.cuh"

namespace cg = cooperative_groups;

#define FP_THREADS 512
#define FP_WARPS (FP_THREADS / 32)
#define MAX_PLACEMENTS 64
#define FP_MAX_CLUSTER 8
#define FP_SMEM_BUDGET (200 * 1024)  // dynamic shared memory a CTA may take

// Candidate flag bits.
#define F_FEAS0 1   // feasible before the distinct_hosts gate
#define F_FEAS 2    // feasible
#define F_FITS 4    // fits, with preemption assist
#define F_PRE 8     // needs preemption
#define F_AA 16     // anti-affinity appended
#define F_PEN 32    // penalty appended
#define F_AFF 64    // affinity appended
#define F_ELIG 128  // the node's eligible bit
#define F_LIVE (F_FEAS | F_FITS)
#define F_COUNTED (F_AA | F_PEN | F_AFF | F_PRE)

struct FPParams {
  NodeTables m;              // the columns feasibility reads
  const float* totals;       // (N, 3)
  const float* used;         // (N, 3)
  const float* prio_used;    // (N, PRIO_BUCKETS, 3)
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
  unsigned char* scratch;      // (B, C, scratch_cta) candidate state, or null
  size_t scratch_cta;
  int n, b, d, k, p, span, umax, in_smem;
  RunWidths rw;
};

// Candidate state, structure of arrays over `cap` entries.
template <class W>
struct Cands {
  int32_t* row;
  float* p4;      // ((binpack + aa) + pen) + aff
  float* bin;
  float* aff;
  float* pre;     // preemption component (W::PRE only)
  int32_t* shash; // [SW][cap] the node's value hash per stanza
  uint8_t* flags;
  uint8_t* sidx;  // [SW][cap] its entry in the stanza's table
};

template <class W>
__host__ __device__ constexpr size_t cand_bytes() {
  return 16 + (W::PRE ? 4 : 0) + 5 * AtLeast1<W::SW>::value + 1;
}

template <class W>
__device__ __forceinline__ Cands<W> cands_at(unsigned char* base, int cap) {
  Cands<W> c;
  c.row = (int32_t*)base;
  c.p4 = (float*)(c.row + cap);
  c.bin = c.p4 + cap;
  c.aff = c.bin + cap;
  float* q = c.aff + cap;
  c.pre = q;
  if (W::PRE) q += cap;
  c.shash = (int32_t*)q;
  c.flags = (uint8_t*)(c.shash + AtLeast1<W::SW>::value * cap);
  c.sidx = c.flags + cap;
  return c;
}

// A row whose usage differs from `used`.
struct UEntry {
  int row;
  float u0, u1, u2;
};

// What a CTA offers at each step.
struct Xchg {
  Best best;
  int c0, c1, c2, pad;
};

__device__ __forceinline__ int find_row(const UEntry* um, int nu, int r) {
  for (int e = 0; e < nu; ++e)
    if (um[e].row == r) return e;
  return -1;
}

template <class W>
__global__ void __launch_bounds__(FP_THREADS, 1)
fused_place_kernel(const __grid_constant__ FPParams P) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_ranks = (int)cluster.num_blocks();
  const int lane = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const int N = P.n;
  const int begin = rank * P.span;
  const int nloc = max(0, min(N, begin + P.span) - begin);
  float* out = P.out + (size_t)lane * P.p * PACKED_WIDTH;

  if (!P.lane_mask[lane]) {  // dead lane: row -1, zeros (the whole cluster)
    if (rank == 0)
      for (int i = tid; i < P.p * PACKED_WIDTH; i += FP_THREADS)
        out[i] = (i % PACKED_WIDTH == 0) ? -1.0f : 0.0f;
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  UEntry* umap = (UEntry*)smem;
  uint32_t* bitmap = (uint32_t*)(smem + align16((size_t)P.umax * sizeof(UEntry)));
  const int bit_words = (P.span + 31) / 32;
  unsigned char* cbase =
      P.in_smem ? (unsigned char*)bitmap + align16((size_t)bit_words * 4)
                : P.scratch + ((size_t)lane * n_ranks + rank) * P.scratch_cta;
  const Cands<W> cd = cands_at<W>(cbase, P.span);

  __shared__ int ri[REQ_INT_WIDTH];
  __shared__ float rf[REQ_FLOAT_WIDTH];
  __shared__ LaneSetup<W> L;
  __shared__ int s_hash[MAX_S * MAX_V];
  __shared__ float s_cnt[MAX_S * MAX_V];
  __shared__ float s_mn[MAX_S], s_mx[MAX_S];
  __shared__ int s_any[MAX_S];
  __shared__ float esc[AtLeast1<W::SW>::value][SPR_ENTRIES];
  __shared__ int ins_entry[MAX_S], ins_hash[MAX_S];
  __shared__ int placed[MAX_PLACEMENTS];
  __shared__ int n_placed, n_umap, n_cand, my_cand;
  __shared__ int cnt[3];
  __shared__ Xchg xchg[2];
  __shared__ Xchg win;
  __shared__ Best w_best[FP_WARPS];
  __shared__ int w_cand[FP_WARPS];

  for (int i = tid; i < REQ_INT_WIDTH; i += FP_THREADS)
    ri[i] = P.req_i[(size_t)lane * REQ_INT_WIDTH + i];
  for (int i = tid; i < REQ_FLOAT_WIDTH; i += FP_THREADS)
    rf[i] = P.req_f[(size_t)lane * REQ_FLOAT_WIDTH + i];
  for (int i = tid; i < MAX_S * MAX_V; i += FP_THREADS)
    s_cnt[i] = P.spread_counts[(size_t)lane * MAX_S * MAX_V + i];
  for (int i = tid; i < bit_words; i += FP_THREADS) bitmap[i] = 0u;
  __syncthreads();
  for (int i = tid; i < MAX_S * MAX_V; i += FP_THREADS)
    s_hash[i] = ri[RI_S_VALUE_HASH + i];
  if (tid == 0) {
    lane_setup<W>(L, ri, rf, P.rw, P.m.a);
    // Lane base usage: used + in-flight deltas, in delta order.
    int nu = 0;
    for (int j = 0; j < P.d; ++j) {
      const int r = P.delta_rows[(size_t)lane * P.d + j];
      if (r < 0 || r >= N) continue;
      int e = find_row(umap, nu, r);
      if (e < 0) {
        e = nu++;
        umap[e] = {r, P.used[r * 3], P.used[r * 3 + 1], P.used[r * 3 + 2]};
      }
      const float* dv = P.delta_vals + ((size_t)lane * P.d + j) * 3;
      umap[e].u0 += dv[0];
      umap[e].u1 += dv[1];
      umap[e].u2 += dv[2];
    }
    n_umap = nu;
    for (int e = 0; e < nu; ++e) {
      const int li = umap[e].row - begin;
      if (li >= 0 && li < nloc) bitmap[li >> 5] |= 1u << (li & 31);
    }
    n_placed = 0;
    n_cand = 0;
    cnt[0] = cnt[1] = cnt[2] = 0;
  }
  __syncthreads();

  // ---- step 0: score every owned node once; keep the candidates.
  {
    GlobalNodes S;
    S.m = &P.m;
    S.totals = P.totals;
    const uint8_t* class_elig = P.class_eligs + (size_t)lane * P.k;
    const int32_t* tg_lane = P.tg_counts + (size_t)lane * N;
    const uint8_t* pen_lane = P.penalties + (size_t)lane * N;
    const uint8_t* host_lane = P.host_masks + (size_t)lane * N;
    int c0 = 0, c1 = 0, c2 = 0;
    // Four nodes a thread per round (rows lid + 32j of the warp's block of
    // 128), their feasibility checks together so their loads overlap.
    constexpr int K = 4;
    for (int base = warp * 32 * K; base < nloc; base += FP_THREADS * K) {
      int li[K], row[K];
      bool host[K], feas0[K], elig[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        li[j] = base + lid + 32 * j;
        const bool valid = li[j] < nloc;
        row[j] = begin + (valid ? li[j] : 0);
        host[j] = valid && host_lane[row[j]] != 0;
      }
      feasible_k<W, K>(S, li, row, L, class_elig, P.k, host, feas0, elig);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int i = row[j];
        const bool valid = li[j] < nloc;
        bool cand = false;
        float p4 = 0.0f, bin = 0.0f, aff = 0.0f, pre = 0.0f;
        int flags = 0;
        const int tg = feas0[j] ? tg_lane[i] : 0;
        const bool feas = feas0[j] && !(L.distinct && tg > 0);
        c0 += feas;
        c1 += valid && !feas && elig[j];
        if (feas) {
          float u0, u1, u2;
          if ((bitmap[li[j] >> 5] >> (li[j] & 31)) & 1u) {
            const UEntry& e = umap[find_row(umap, n_umap, i)];
            u0 = e.u0;
            u1 = e.u1;
            u2 = e.u2;
          } else {
            u0 = P.used[i * 3];
            u1 = P.used[i * 3 + 1];
            u2 = P.used[i * 3 + 2];
          }
          float t0, t1, t2;
          S.tot(li[j], i, t0, t1, t2);
          const FitParts f =
              fit_parts<W>(L, P.prio_used, i, u0, u1, u2, t0, t1, t2);
          c2 += !f.fits_all;
          if (f.fits_all) {
            cand = true;
            bool aa_app, aff_app;
            const float aa = anti_affinity(tg, L.desired, aa_app);
            const bool pen_app = pen_lane[i] != 0;
            aff = affinity<W>(S, li[j], i, L, aff_app);
            p4 = partial_sum(f.binpack, aa, pen_app ? -1.0f : 0.0f, aff);
            bin = f.binpack;
            pre = f.pre;
            flags = F_FEAS0 | F_FEAS | F_FITS | (elig[j] ? F_ELIG : 0) |
                    (f.needs_pre ? F_PRE : 0) | (aa_app ? F_AA : 0) |
                    (pen_app ? F_PEN : 0) | (aff_app ? F_AFF : 0);
          }
        }
        const unsigned bal = __ballot_sync(0xffffffffu, cand);
        int slot0 = 0;
        if (lid == 0 && bal) slot0 = atomicAdd(&n_cand, __popc(bal));
        slot0 = __shfl_sync(0xffffffffu, slot0, 0);
        if (cand) {
          const int c = slot0 + __popc(bal & ((1u << lid) - 1u));
          cd.row[c] = i;
          cd.p4[c] = p4;
          cd.bin[c] = bin;
          cd.aff[c] = aff;
          if (W::PRE) cd.pre[c] = pre;
          cd.flags[c] = (uint8_t)flags;
#pragma unroll
          for (int s = 0; s < W::SW; ++s) {
            int nv = 0, e = SPR_NOVALUE;
            if (L.s_on[s]) {
              nv = S.hash(li[j], i, -1, L.s_slot[s]);
              e = spread_entry_of(nv, s, s_hash);
            }
            cd.shash[s * P.span + c] = nv;
            cd.sidx[s * P.span + c] = (uint8_t)e;
          }
        }
      }
    }
    c0 = __reduce_add_sync(0xffffffffu, c0);
    c1 = __reduce_add_sync(0xffffffffu, c1);
    c2 = __reduce_add_sync(0xffffffffu, c2);
    if (lid == 0) {
      atomicAdd(&cnt[0], c0);
      atomicAdd(&cnt[1], c1);
      atomicAdd(&cnt[2], c2);
    }
  }
  __syncthreads();
  const int nc = n_cand;

  // ---- the scan
  for (int step = 0; step < P.p; ++step) {
    if (tid == 0) even_spread_stats(s_hash, s_cnt, s_mn, s_mx, s_any);
    __syncthreads();
    for (int e = tid; e < W::SW * SPR_ENTRIES; e += FP_THREADS) {
      const int s = e / SPR_ENTRIES;
      if (L.s_on[s])
        esc[s][e % SPR_ENTRIES] = spread_entry_score(
            e % SPR_ENTRIES, s, ri, rf, s_hash, s_cnt, s_mn, s_mx, s_any);
    }
    __syncthreads();

    Best best = {-CUDART_INF_F, 0x7fffffff, 0.0f, 0};
    int bc = -1;
    for (int c = tid; c < nc; c += FP_THREADS) {
      const int f = cd.flags[c];
      if ((f & F_LIVE) != F_LIVE) continue;
      float spr_total = 0.0f;
#pragma unroll
      for (int s = 0; s < W::SW; ++s)
        if (L.s_on[s]) spr_total = spr_total + esc[s][cd.sidx[s * P.span + c]];
      const float fin =
          score_of(cd.p4[c], spr_total, L.has_spread,
                   W::PRE ? cd.pre[c] : 0.0f, __popc(f & F_COUNTED));
      const int r = cd.row[c];
      if (better(fin, r, best.val, best.row)) {
        best.val = fin;
        best.row = r;
        best.bin = cd.bin[c];
        best.pre = (f & F_PRE) != 0;
        bc = c;
      }
    }
    // Block argmax, carrying the candidate index.
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best.val, off);
      const int orow = __shfl_down_sync(0xffffffffu, best.row, off);
      const float ob = __shfl_down_sync(0xffffffffu, best.bin, off);
      const int op = __shfl_down_sync(0xffffffffu, best.pre, off);
      const int oc = __shfl_down_sync(0xffffffffu, bc, off);
      if (better(ov, orow, best.val, best.row)) {
        best.val = ov;
        best.row = orow;
        best.bin = ob;
        best.pre = op;
        bc = oc;
      }
    }
    if (lid == 0) {
      w_best[warp] = best;
      w_cand[warp] = bc;
    }
    __syncthreads();
    if (tid == 0) {
      for (int wi = 1; wi < FP_WARPS; ++wi)
        if (better(w_best[wi].val, w_best[wi].row, best.val, best.row)) {
          best = w_best[wi];
          bc = w_cand[wi];
        }
      Xchg& x = xchg[step & 1];
      x.best = best;
      x.c0 = cnt[0];
      x.c1 = cnt[1];
      x.c2 = cnt[2];
      my_cand = bc;
    }
    cluster.sync();
    // Every CTA reads every CTA's offer and picks the same winner.
    if (warp == 0) {
      Xchg o;
      if (lid < n_ranks) {
        o = *cluster.map_shared_rank(&xchg[step & 1], lid);
      } else {
        o.best = {-CUDART_INF_F, 0x7fffffff, 0.0f, 0};
        o.c0 = o.c1 = o.c2 = 0;
      }
      Best b = o.best;
      int c0 = o.c0, c1 = o.c1, c2 = o.c2;
      warp_best(b, c0, c1, c2);
      if (lid == 0) {
        win.best = b;
        win.c0 = c0;
        win.c1 = c1;
        win.c2 = c2;
      }
    }
    __syncthreads();
    const Best wb = win.best;
    const bool ok = wb.val > NEG_INF_F / 2.0f;
    if (rank == 0 && tid == 0) {
      float* o = out + (size_t)step * PACKED_WIDTH;
      o[0] = ok ? (float)wb.row : -1.0f;
      o[1] = ok ? wb.val : 0.0f;
      o[2] = ok ? wb.bin : 0.0f;
      o[3] = (ok && wb.pre) ? 1.0f : 0.0f;
      o[4] = (float)win.c0;
      o[5] = (float)win.c1;
      o[6] = (float)win.c2;
      // A failed step leaves the carry unchanged: every later step gives
      // the same output.
      if (!ok)
        for (int st = step + 1; st < P.p; ++st)
          for (int c = 0; c < PACKED_WIDTH; ++c)
            out[(size_t)st * PACKED_WIDTH + c] = o[c];
    }
    if (!ok) break;

    // ---- the carry: warp 0 updates the spread tables while warp 1's
    // first thread rescores the winner in its owner CTA.
    const int r = wb.row;
    if (tid == 0) {
      // apply_spread_values (kernels.py:677) on the winner's values, in
      // every CTA's copy of the tables.
      for (int s = 0; s < MAX_S; ++s) {
        ins_entry[s] = -1;
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
        if (can && !have) {
          vh[idx] = nv;
          ins_entry[s] = idx;
          ins_hash[s] = nv;
        }
        if (can) s_cnt[s * MAX_V + idx] += 1.0f;
      }
    }
    if (tid == 32) {
      placed[n_placed++] = r;
      // The owner rescoring its winner row with the ask applied.
      if (r >= begin && r < begin + nloc) {
        const int c = my_cand;
        int e = find_row(umap, n_umap, r);
        if (e < 0) {
          e = n_umap++;
          umap[e] = {r, P.used[r * 3], P.used[r * 3 + 1], P.used[r * 3 + 2]};
        }
        umap[e].u0 += L.ask0;
        umap[e].u1 += L.ask1;
        umap[e].u2 += L.ask2;
        int tg = P.tg_counts[(size_t)lane * N + r];
        for (int j = 0; j < n_placed; ++j) tg += placed[j] == r;
        const int f_old = cd.flags[c];
        const bool elig = (f_old & F_ELIG) != 0;
        const bool feas = (f_old & F_FEAS0) && !(L.distinct && tg > 0);
        int flags = f_old & (F_FEAS0 | F_PEN | F_AFF | F_ELIG);
        bool fits_all = false;
        if (feas) {
          const FitParts f =
              fit_parts<W>(L, P.prio_used, r, umap[e].u0, umap[e].u1,
                           umap[e].u2, P.totals[r * 3], P.totals[r * 3 + 1],
                           P.totals[r * 3 + 2]);
          fits_all = f.fits_all;
          flags |= F_FEAS | (fits_all ? F_FITS : 0) | (f.needs_pre ? F_PRE : 0);
          if (fits_all) {
            bool aa_app;
            const float aa = anti_affinity(tg, L.desired, aa_app);
            flags |= aa_app ? F_AA : 0;
            cd.p4[c] = partial_sum(f.binpack, aa,
                                   (f_old & F_PEN) ? -1.0f : 0.0f, cd.aff[c]);
            cd.bin[c] = f.binpack;
            if (W::PRE) cd.pre[c] = f.pre;
          }
        }
        cd.flags[c] = (uint8_t)flags;
        // The winner counted as evaluated and neither filtered nor
        // exhausted; count it as it is now.
        cnt[0] += (feas ? 1 : 0) - 1;
        cnt[1] += (!feas && elig) ? 1 : 0;
        cnt[2] += (feas && !fits_all) ? 1 : 0;
      }
    }
    __syncthreads();
    // A value new to a table: the candidates holding it leave "no match".
#pragma unroll
    for (int s = 0; s < W::SW; ++s) {
      const int entry = ins_entry[s];
      if (entry < 0) continue;
      const int h = ins_hash[s];
      for (int c = tid; c < nc; c += FP_THREADS)
        if (cd.sidx[s * P.span + c] == SPR_NOMATCH && cd.shash[s * P.span + c] == h)
          cd.sidx[s * P.span + c] = (uint8_t)entry;
    }
    __syncthreads();
  }
  cluster.sync();  // keep this CTA's offers alive until every CTA read them
}

// Launch shape: cluster size, each CTA's node span, dynamic shared memory
// and, where the candidate state does not fit it, scratch bytes per CTA.
struct FPShape {
  int c, span, umax, in_smem;
  size_t smem, scratch_cta;
};

static int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

static size_t cand_bytes_of(int tier) {
  return tier == 0 ? cand_bytes<WidthsBench>() : cand_bytes<WidthsFull>();
}

static FPShape fp_shape(int n, int b, int d, int p, int tier) {
  FPShape sh;
  int c = sm_count() / (b > 0 ? b : 1);
  if (c < 2) c = 2;
  if (c > FP_MAX_CLUSTER) c = FP_MAX_CLUSTER;
  sh.umax = d + p;
  const size_t per = cand_bytes_of(tier);
  for (;; ++c) {
    sh.c = c;
    const int each = (n + c - 1) / c;
    sh.span = (each + 31) / 32 * 32;
    const size_t fixed = align16((size_t)sh.umax * sizeof(UEntry)) +
                         align16((size_t)sh.span / 32 * 4);
    const size_t cands = align16((size_t)sh.span * per);
    if (fixed + cands <= FP_SMEM_BUDGET) {
      sh.in_smem = 1;
      sh.smem = fixed + cands;
      sh.scratch_cta = 0;
      return sh;
    }
    if (c == FP_MAX_CLUSTER) {
      sh.in_smem = 0;
      sh.smem = fixed;
      sh.scratch_cta = cands;
      return sh;
    }
  }
}

template <class W>
static int launch(const FPParams& P, const FPShape& sh, cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_place_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FP_SMEM_BUDGET);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  if (sh.smem > FP_SMEM_BUDGET) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.c, P.b, 1);
  cfg.blockDim = dim3(FP_THREADS, 1, 1);
  cfg.dynamicSmemBytes = sh.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, fused_place_kernel<W>, P);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch shape the entry would use: {cluster size, node span per CTA,
// dynamic shared memory bytes, candidate state in shared memory (1) or
// scratch (0), scratch bytes per CTA, instantiation tier}.
extern "C" int nomad_fused_place_shape(int n, int b, int d, int p, int c_width,
                                       int a_width, int s_width, int preempt,
                                       int ports, long long* out) {
  const RunWidths rw = {c_width, a_width, s_width, preempt, ports};
  const int tier = widths_tier(rw);
  const FPShape sh = fp_shape(n, b, d, p, tier);
  out[0] = sh.c;
  out[1] = sh.span;
  out[2] = (long long)sh.smem;
  out[3] = sh.in_smem;
  out[4] = (long long)sh.scratch_cta;
  out[5] = tier;
  return 6;
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
    const uint8_t* lane_mask, float* out, unsigned char* scratch, int n, int a,
    int w, int b, int d, int k, int p, int c_width, int a_width, int s_width,
    int preempt, int ports, cudaStream_t stream) {
  if (p > MAX_PLACEMENTS || p < 1 || c_width > MAX_C || a_width > MAX_A ||
      s_width > MAX_S || c_width < 0 || a_width < 0 || s_width < 0 || n <= 0 ||
      b <= 0 || k <= 0 || a <= 0 || d < 0 || d > MAX_LANE_DELTAS)
    return (int)cudaErrorInvalidValue;
  FPParams P;
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
  P.n = n;
  P.b = b;
  P.d = d;
  P.k = k;
  P.p = p;
  P.rw = {c_width, a_width, s_width, preempt, ports};
  const int tier = widths_tier(P.rw);
  const FPShape sh = fp_shape(n, b, d, p, tier);
  if (!sh.in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  P.scratch = scratch;
  P.scratch_cta = sh.scratch_cta;
  P.span = sh.span;
  P.umax = sh.umax;
  P.in_smem = sh.in_smem;
  if (tier == 0) return launch<WidthsBench>(P, sh, stream);
  return launch<WidthsFull>(P, sh, stream);
}
