// The hoisted placement scan's candidate state and step code, shared by
// fused_place.cu (one lane's scan in one launch) and sharded_place.cu (one
// step of every lane of every node shard on a card per launch).
//
// A node that is feasible and fits at step 0 is a candidate and keeps its
// state: the partial sum ((binpack + anti-affinity) + penalty) + affinity
// in the plain version's order, binpack, affinity, the preemption
// component, the appended and feasibility bits, and per spread stanza its
// value hash and the index of its value in the lane's value table.  Nodes
// that are not candidates can only stay so (usage only grows at a
// winner), so the three node counters are counted once and then adjusted
// at each winner.  Each later step needs only the spread term, which
// changes for every node but only through the lane's value table: the step
// scores the table's entries (scoring.cuh spread_entry_score) and each
// candidate looks its entry up, adds it and the preemption component to its
// partial sum and divides by its count.
//
// Numerics: the same scoring.cuh calls in the same order as the plain
// version; the kernels that include this file build with -fmad=false and
// no fast math.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "layout.cuh"
#include "scoring.cuh"

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

// What a CTA offers the other CTAs of its cluster at each step.
struct Xchg {
  Best best;
  int c0, c1, c2, pad;
};

__device__ __forceinline__ int find_row(const UEntry* um, int nu, int r) {
  for (int e = 0; e < nu; ++e)
    if (um[e].row == r) return e;
  return -1;
}

// Step 0 for K nodes of one thread (rows row[j] of the matrix, li[j] their
// position in the owner's span, valid where li[j] < nloc; their
// feasibility before distinct_hosts in feas0/elig): the full score of each
// one that is feasible and fits, kept as a candidate (slots taken a warp
// at a time from *n_cand), and the three node counters added to c0..c2.
// `usage(li, row, u0, u1, u2)` gives the lane's usage of a row where it
// differs from `used`, and returns false where it does not.
template <class W, int K, class Usage>
__device__ __forceinline__ void keep_candidates(
    const GlobalNodes& S, const LaneSetup<W>& L, const float* used,
    const float* prio_used, const int32_t* tg_lane, const uint8_t* pen_lane,
    const int* li, const int* row, int nloc, const bool* feas0,
    const bool* elig, const int* s_hash, const Cands<W>& cd, int cap,
    int* n_cand, int& c0, int& c1, int& c2, Usage usage) {
  const int lid = threadIdx.x & 31;
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
      if (!usage(li[j], i, u0, u1, u2)) {
        u0 = used[i * 3];
        u1 = used[i * 3 + 1];
        u2 = used[i * 3 + 2];
      }
      float t0, t1, t2;
      S.tot(li[j], i, t0, t1, t2);
      const FitParts f = fit_parts<W>(L, prio_used, i, u0, u1, u2, t0, t1, t2);
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
    if (lid == 0 && bal) slot0 = atomicAdd(n_cand, __popc(bal));
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
        cd.shash[s * cap + c] = nv;
        cd.sidx[s * cap + c] = (uint8_t)e;
      }
    }
  }
}

// The spread entry scores of the lane's value tables (one entry a thread;
// s_mn/s_mx/s_any from even_spread_stats).
template <class W, int T>
__device__ __forceinline__ void spread_entry_scores(
    float (*esc)[SPR_ENTRIES], const LaneSetup<W>& L, const int* ri,
    const float* rf, const int* s_hash, const float* s_cnt, const float* s_mn,
    const float* s_mx, const int* s_any) {
  for (int e = threadIdx.x; e < W::SW * SPR_ENTRIES; e += T) {
    const int s = e / SPR_ENTRIES;
    if (L.s_on[s])
      esc[s][e % SPR_ENTRIES] = spread_entry_score(
          e % SPR_ENTRIES, s, ri, rf, s_hash, s_cnt, s_mn, s_mx, s_any);
  }
}

// The block's best candidate (highest score, lowest row) at this step:
// every thread scans its candidates, warps reduce carrying the candidate
// index, and thread 0 returns the block's best in `best` and its index in
// `bc` (-1 when there is none).  `w_best`/`w_cand` hold T / 32 entries of
// shared memory.
template <class W, int T>
__device__ __forceinline__ void block_best(const Cands<W>& cd, int nc, int cap,
                                           const LaneSetup<W>& L,
                                           float (*esc)[SPR_ENTRIES],
                                           Best* w_best, int* w_cand,
                                           Best& best, int& bc) {
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  best = {-CUDART_INF_F, 0x7fffffff, 0.0f, 0};
  bc = -1;
  for (int c = tid; c < nc; c += T) {
    const int f = cd.flags[c];
    if ((f & F_LIVE) != F_LIVE) continue;
    float spr_total = 0.0f;
#pragma unroll
    for (int s = 0; s < W::SW; ++s)
      if (L.s_on[s]) spr_total = spr_total + esc[s][cd.sidx[s * cap + c]];
    const float fin =
        score_of(cd.p4[c], spr_total, L.has_spread, W::PRE ? cd.pre[c] : 0.0f,
                 __popc(f & F_COUNTED));
    const int r = cd.row[c];
    if (better(fin, r, best.val, best.row)) {
      best.val = fin;
      best.row = r;
      best.bin = cd.bin[c];
      best.pre = (f & F_PRE) != 0;
      bc = c;
    }
  }
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
  if (tid == 0)
    for (int wi = 1; wi < T / 32; ++wi)
      if (better(w_best[wi].val, w_best[wi].row, best.val, best.row)) {
        best = w_best[wi];
        bc = w_cand[wi];
      }
}

// apply_spread_values (kernels.py:677) for stanza s on the winner's value
// `nv`: the value's entry gets one more count, a value new to the table
// takes its first free entry (returned in *ins_entry, else -1).
__device__ __forceinline__ void apply_spread_value(int s, int slot, int nv,
                                                   int* s_hash, float* s_cnt,
                                                   int* ins_entry) {
  *ins_entry = -1;
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
    *ins_entry = idx;
  }
  if (can) s_cnt[s * MAX_V + idx] += 1.0f;
}

// The winner's owner rescoring candidate c (matrix row r) with the ask
// applied: usage (u0, u1, u2) after it, totals (t0, t1, t2), `tg` its
// group count with this placement.  Updates its state and the three
// counters (the winner counted as evaluated and neither filtered nor
// exhausted; it is counted as it is now).
template <class W>
__device__ __forceinline__ void rescore_winner(const Cands<W>& cd, int c,
                                               const LaneSetup<W>& L,
                                               const float* prio_used, int r,
                                               float u0, float u1, float u2,
                                               float t0, float t1, float t2,
                                               int tg, int* cnt) {
  const int f_old = cd.flags[c];
  const bool elig = (f_old & F_ELIG) != 0;
  const bool feas = (f_old & F_FEAS0) && !(L.distinct && tg > 0);
  int flags = f_old & (F_FEAS0 | F_PEN | F_AFF | F_ELIG);
  bool fits_all = false;
  if (feas) {
    const FitParts f = fit_parts<W>(L, prio_used, r, u0, u1, u2, t0, t1, t2);
    fits_all = f.fits_all;
    flags |= F_FEAS | (fits_all ? F_FITS : 0) | (f.needs_pre ? F_PRE : 0);
    if (fits_all) {
      bool aa_app;
      const float aa = anti_affinity(tg, L.desired, aa_app);
      flags |= aa_app ? F_AA : 0;
      cd.p4[c] = partial_sum(f.binpack, aa, (f_old & F_PEN) ? -1.0f : 0.0f,
                             cd.aff[c]);
      cd.bin[c] = f.binpack;
      if (W::PRE) cd.pre[c] = f.pre;
    }
  }
  cd.flags[c] = (uint8_t)flags;
  cnt[0] += (feas ? 1 : 0) - 1;
  cnt[1] += (!feas && elig) ? 1 : 0;
  cnt[2] += (feas && !fits_all) ? 1 : 0;
}

// A value new to a stanza's table: the candidates holding its hash leave
// "no match" for its entry.
template <class W, int T>
__device__ __forceinline__ void enter_values(const Cands<W>& cd, int nc,
                                             int cap, const int* ins_entry,
                                             const int* ins_hash) {
#pragma unroll
  for (int s = 0; s < W::SW; ++s) {
    const int entry = ins_entry[s];
    if (entry < 0) continue;
    const int h = ins_hash[s];
    for (int c = threadIdx.x; c < nc; c += T)
      if (cd.sidx[s * cap + c] == SPR_NOMATCH && cd.shash[s * cap + c] == h)
        cd.sidx[s * cap + c] = (uint8_t)entry;
  }
}
