// sharded_place — one placement step of every lane over one node shard.
//
// Replaces the per-shard bodies of the JAX package's node-sharded programs
// (nomad_tpu/parallel/sharding.py): _place_batch_local (:334, the staged
// sharded dispatch), the ranking scan of _fused_place_batch_local (:480,
// TOPK_K = 1, so the hierarchical top-k is each shard's argmax) and
// _step_local (:243, one step with no carried state).  There the node axis
// is split over a ('batch', 'node') mesh and pmax/pmin/psum reduce across
// shards inside one SPMD program.  Here each shard is a launch on its own
// card (or a virtual shard of one card), and the reduction across shards
// is a table of offers that the shards exchange between launches.
//
// A dispatch of P placements is P + 1 launches on every shard; launch t:
// * t > 0: reduces step t-1's candidate table, the (S, B) offers every
//   node shard of this batch row wrote (highest score, then the lowest
//   GLOBAL row; n_eval, n_filt and n_exh summed; binpack, preemption and
//   the spread values the winner's owner recorded).  Every shard reduces
//   the same table in the same order, so every shard picks the same
//   winner.  It writes the step's packed row, the owner applies the ask
//   and the tg count at its local row, and every shard applies the
//   winner's spread values to its lane tables (apply_spread_values,
//   nomad_tpu/ops/kernels.py:677, the order fused_place.cu keeps).
// * t < P: scores every row of the shard with the full score (scoring.cuh
//   and feasibility.cuh, the per-node arithmetic of fused_place.cu in the
//   same order), takes the shard's argmax (lowest row on ties) and the
//   three node counters, and writes its offer for step t.
// Launch 0 also builds the lane state: the usage that differs from `used`
// (the lane's in-flight deltas on this shard's rows, summed in delta
// order, and its placements), tg-count increments and the spread tables,
// kept in a device scratch the wrapper allocates, between launches.
// Offers live in a table of two parities (step & 1), one table per shard:
// the wrapper copies each shard's offers into the other shards' tables of
// its batch row after every launch, ordered by CUDA events; no launch
// waits on another inside the device.
//
// Rows past the claimed ones inside a shard's block are not eligible
// (NodeMatrix zeroes them), so they are never feasible and never win.
//
// What bounds it on an H100: per step, the shard's slice of the matrix
// columns feasibility reads (each row's attributes, totals, usage) read
// once a lane; at 10,240 rows over 2-4 shards that is a few MB a step, a
// few microseconds at 3.35 TB/s, and the launches, the exchange and the
// dependent steps, not the bytes, set the time.  This first design
// rescores every row at every step, as fused_place.cu's first design did.
//
// Numerics: built without --use_fast_math and with -fmad=false, as the
// other kernels: every score rounds as in fused_place.cu and the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "feasibility.cuh"
#include "layout.cuh"
#include "per_device.cuh"
#include "scoring.cuh"

#define SP_THREADS 512
#define SP_WARPS (SP_THREADS / 32)
#define SP_MAX_PLACEMENTS 64
// An offer: score bits, global row, binpack bits, preemption flag, the
// three counters, the winner's value hash per spread stanza, padding.
#define OFFER_WORDS 12
// Lane state words before the usage table: n_umap and padding, the spread
// value hashes, the spread counts.
#define ST_HEAD 16
#define ST_HASH 16
#define ST_CNT (ST_HASH + MAX_S * MAX_V)
#define ST_UMAP (ST_CNT + MAX_S * MAX_V)
#define UE_WORDS 5  // row, u0, u1, u2, tg increments

struct SPParams {
  NodeTables m;                // the shard's columns feasibility reads
  const float* totals;         // (n, 3)
  const float* used;           // (n, 3)
  const float* prio_used;      // (n, PRIO_BUCKETS, 3)
  const int32_t* delta_rows;   // (B, D) global rows
  const float* delta_vals;     // (B, D, 3)
  const int32_t* tg_counts;    // (B, n)
  const float* spread_counts;  // (B, MAX_S, MAX_V)
  const uint8_t* penalties;    // (B, n)
  const int32_t* req_i;        // (B, REQ_INT_WIDTH)
  const float* req_f;          // (B, REQ_FLOAT_WIDTH)
  const uint8_t* class_eligs;  // (B, K)
  const uint8_t* host_masks;   // (B, n)
  const uint8_t* lane_mask;    // (B,)
  int32_t* table;              // (2, S, B, OFFER_WORDS)
  int32_t* state;              // (B, lane_words)
  float* out;                  // (B, P, PACKED_WIDTH)
  int n, off, b, d, k, p, shards, shard, step, umax, lane_words;
  RunWidths rw;
};

__host__ __device__ inline int sp_umax(int d, int p) { return d + p; }

__host__ __device__ inline int sp_lane_words(int n, int d, int p) {
  return ST_UMAP + UE_WORDS * sp_umax(d, p) + (n + 31) / 32;
}

__device__ __forceinline__ int sp_find(const int32_t* umap, int nu, int r) {
  for (int e = 0; e < nu; ++e)
    if (umap[e * UE_WORDS] == r) return e;
  return -1;
}

template <class W>
__global__ void __launch_bounds__(SP_THREADS)
sharded_place_kernel(const __grid_constant__ SPParams P) {
  const int lane = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lid = tid & 31;
  const int N = P.n;
  float* out = P.out + (size_t)lane * P.p * PACKED_WIDTH;

  if (!P.lane_mask[lane]) {  // dead lane: row -1, zeros, at the last launch
    if (P.step == P.p)
      for (int i = tid; i < P.p * PACKED_WIDTH; i += SP_THREADS)
        out[i] = (i % PACKED_WIDTH == 0) ? -1.0f : 0.0f;
    return;
  }

  int32_t* st = P.state + (size_t)lane * P.lane_words;
  int32_t* umap = st + ST_UMAP;
  uint32_t* bitmap = (uint32_t*)(st + ST_UMAP + UE_WORDS * P.umax);
  const int bit_words = (N + 31) / 32;

  __shared__ int ri[REQ_INT_WIDTH];
  __shared__ float rf[REQ_FLOAT_WIDTH];
  __shared__ LaneSetup<W> L;
  __shared__ int s_hash[MAX_S * MAX_V];
  __shared__ float s_cnt[MAX_S * MAX_V];
  __shared__ float s_mn[MAX_S], s_mx[MAX_S];
  __shared__ int s_any[MAX_S];
  __shared__ float esc[AtLeast1<W::SW>::value][SPR_ENTRIES];
  __shared__ int n_umap;
  __shared__ int cnt[3];
  __shared__ Best w_best[SP_WARPS];

  for (int i = tid; i < REQ_INT_WIDTH; i += SP_THREADS)
    ri[i] = P.req_i[(size_t)lane * REQ_INT_WIDTH + i];
  for (int i = tid; i < REQ_FLOAT_WIDTH; i += SP_THREADS)
    rf[i] = P.req_f[(size_t)lane * REQ_FLOAT_WIDTH + i];
  if (P.step == 0) {
    for (int i = tid; i < MAX_S * MAX_V; i += SP_THREADS)
      s_cnt[i] = P.spread_counts[(size_t)lane * MAX_S * MAX_V + i];
    for (int i = tid; i < bit_words; i += SP_THREADS) bitmap[i] = 0u;
  } else {
    for (int i = tid; i < MAX_S * MAX_V; i += SP_THREADS) {
      s_hash[i] = st[ST_HASH + i];
      s_cnt[i] = __int_as_float(st[ST_CNT + i]);
    }
  }
  __syncthreads();

  if (tid == 0) {
    lane_setup<W>(L, ri, rf, P.rw, P.m.a);
    cnt[0] = cnt[1] = cnt[2] = 0;
    if (P.step == 0) {
      for (int i = 0; i < MAX_S * MAX_V; ++i) s_hash[i] = ri[RI_S_VALUE_HASH + i];
      // Lane base usage on this shard's rows: used + in-flight deltas, in
      // delta order.
      int nu = 0;
      for (int j = 0; j < P.d; ++j) {
        const int r = P.delta_rows[(size_t)lane * P.d + j] - P.off;
        if (r < 0 || r >= N) continue;
        int e = sp_find(umap, nu, r);
        if (e < 0) {
          e = nu++;
          int32_t* u = umap + e * UE_WORDS;
          u[0] = r;
          u[1] = __float_as_int(P.used[r * 3]);
          u[2] = __float_as_int(P.used[r * 3 + 1]);
          u[3] = __float_as_int(P.used[r * 3 + 2]);
          u[4] = 0;
          bitmap[r >> 5] |= 1u << (r & 31);
        }
        int32_t* u = umap + e * UE_WORDS;
        const float* dv = P.delta_vals + ((size_t)lane * P.d + j) * 3;
        u[1] = __float_as_int(__int_as_float(u[1]) + dv[0]);
        u[2] = __float_as_int(__int_as_float(u[2]) + dv[1]);
        u[3] = __float_as_int(__int_as_float(u[3]) + dv[2]);
      }
      n_umap = nu;
    } else {
      n_umap = st[0];
      // ---- reduce step - 1 over every node shard's offer.
      const int prev = P.step - 1;
      const int32_t* tab = P.table + (size_t)(prev & 1) * P.shards * P.b * OFFER_WORDS;
      Best b = {-CUDART_INF_F, 0x7fffffff, 0.0f, 0};
      int c0 = 0, c1 = 0, c2 = 0, win = 0;
      for (int s = 0; s < P.shards; ++s) {
        const int32_t* o = tab + ((size_t)s * P.b + lane) * OFFER_WORDS;
        const float v = __int_as_float(o[0]);
        if (better(v, o[1], b.val, b.row)) {
          b.val = v;
          b.row = o[1];
          b.bin = __int_as_float(o[2]);
          b.pre = o[3];
          win = s;
        }
        c0 += o[4];
        c1 += o[5];
        c2 += o[6];
      }
      const bool ok = b.val > NEG_INF_F / 2.0f;
      float* o = out + (size_t)prev * PACKED_WIDTH;
      o[0] = ok ? (float)b.row : -1.0f;
      o[1] = ok ? b.val : 0.0f;
      o[2] = ok ? b.bin : 0.0f;
      o[3] = (ok && b.pre) ? 1.0f : 0.0f;
      o[4] = (float)c0;
      o[5] = (float)c1;
      o[6] = (float)c2;
      if (ok) {
        // apply_spread_values on the winner's values (its owner recorded
        // them in the offer).
        const int32_t* wo = tab + ((size_t)win * P.b + lane) * OFFER_WORDS;
        for (int s = 0; s < MAX_S; ++s) {
          const int slot = ri[RI_S_SLOT + s];
          const int nv = wo[7 + s];
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
        // The owner applies the ask and the tg count at its row.
        const int r = b.row - P.off;
        if (r >= 0 && r < N) {
          int e = sp_find(umap, n_umap, r);
          if (e < 0) {
            e = n_umap++;
            int32_t* u = umap + e * UE_WORDS;
            u[0] = r;
            u[1] = __float_as_int(P.used[r * 3]);
            u[2] = __float_as_int(P.used[r * 3 + 1]);
            u[3] = __float_as_int(P.used[r * 3 + 2]);
            u[4] = 0;
            bitmap[r >> 5] |= 1u << (r & 31);
          }
          int32_t* u = umap + e * UE_WORDS;
          u[1] = __float_as_int(__int_as_float(u[1]) + L.ask0);
          u[2] = __float_as_int(__int_as_float(u[2]) + L.ask1);
          u[3] = __float_as_int(__int_as_float(u[3]) + L.ask2);
          u[4] += 1;
        }
      }
    }
    st[0] = n_umap;
    for (int i = 0; i < MAX_S * MAX_V; ++i) {
      st[ST_HASH + i] = s_hash[i];
      st[ST_CNT + i] = __float_as_int(s_cnt[i]);
    }
  }
  __syncthreads();
  if (P.step == P.p) return;

  // ---- score every row of the shard for this step.
  if (tid == 0) even_spread_stats(s_hash, s_cnt, s_mn, s_mx, s_any);
  __syncthreads();
  for (int e = tid; e < W::SW * SPR_ENTRIES; e += SP_THREADS) {
    const int s = e / SPR_ENTRIES;
    if (L.s_on[s])
      esc[s][e % SPR_ENTRIES] = spread_entry_score(
          e % SPR_ENTRIES, s, ri, rf, s_hash, s_cnt, s_mn, s_mx, s_any);
  }
  __syncthreads();

  GlobalNodes S;
  S.m = &P.m;
  S.totals = P.totals;
  const uint8_t* class_elig = P.class_eligs + (size_t)lane * P.k;
  const int32_t* tg_lane = P.tg_counts + (size_t)lane * N;
  const uint8_t* pen_lane = P.penalties + (size_t)lane * N;
  const uint8_t* host_lane = P.host_masks + (size_t)lane * N;
  const int nu = n_umap;
  Best best = {-CUDART_INF_F, 0x7fffffff, 0.0f, 0};
  int c0 = 0, c1 = 0, c2 = 0;
  constexpr int K = 4;
  for (int base = warp * 32 * K; base < N; base += SP_THREADS * K) {
    int li[K], row[K];
    bool host[K], feas0[K], elig[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      li[j] = base + lid + 32 * j;
      const bool valid = li[j] < N;
      row[j] = valid ? li[j] : 0;
      host[j] = valid && host_lane[row[j]] != 0;
    }
    feasible_k<W, K>(S, li, row, L, class_elig, P.k, host, feas0, elig);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = row[j];
      const bool valid = li[j] < N;
      int e = -1;
      if (valid && ((bitmap[i >> 5] >> (i & 31)) & 1u)) e = sp_find(umap, nu, i);
      const int tg = feas0[j] ? tg_lane[i] + (e >= 0 ? umap[e * UE_WORDS + 4] : 0)
                              : 0;
      const bool feas = feas0[j] && !(L.distinct && tg > 0);
      c0 += feas;
      c1 += valid && !feas && elig[j];
      if (!feas) continue;
      float u0, u1, u2;
      if (e >= 0) {
        u0 = __int_as_float(umap[e * UE_WORDS + 1]);
        u1 = __int_as_float(umap[e * UE_WORDS + 2]);
        u2 = __int_as_float(umap[e * UE_WORDS + 3]);
      } else {
        u0 = P.used[i * 3];
        u1 = P.used[i * 3 + 1];
        u2 = P.used[i * 3 + 2];
      }
      float t0, t1, t2;
      S.tot(li[j], i, t0, t1, t2);
      const FitParts f = fit_parts<W>(L, P.prio_used, i, u0, u1, u2, t0, t1, t2);
      c2 += !f.fits_all;
      if (!f.fits_all) continue;
      bool aa_app, aff_app;
      const float aa = anti_affinity(tg, L.desired, aa_app);
      const bool pen_app = pen_lane[i] != 0;
      const float aff = affinity<W>(S, li[j], i, L, aff_app);
      const float p4 = partial_sum(f.binpack, aa, pen_app ? -1.0f : 0.0f, aff);
      float spr_total = 0.0f;
#pragma unroll
      for (int s = 0; s < W::SW; ++s)
        if (L.s_on[s])
          spr_total = spr_total +
                      esc[s][spread_entry_of(S.hash(li[j], i, -1, L.s_slot[s]),
                                             s, s_hash)];
      const float fin = score_of(
          p4, spr_total, L.has_spread, W::PRE ? f.pre : 0.0f,
          (int)aa_app + (int)pen_app + (int)aff_app + (int)f.needs_pre);
      if (better(fin, i, best.val, best.row)) {
        best.val = fin;
        best.row = i;
        best.bin = f.binpack;
        best.pre = f.needs_pre;
      }
    }
  }
  warp_best(best, c0, c1, c2);
  if (lid == 0) {
    w_best[warp] = best;
    atomicAdd(&cnt[0], c0);
    atomicAdd(&cnt[1], c1);
    atomicAdd(&cnt[2], c2);
  }
  __syncthreads();
  if (tid == 0) {
    for (int wi = 1; wi < SP_WARPS; ++wi)
      if (better(w_best[wi].val, w_best[wi].row, best.val, best.row))
        best = w_best[wi];
    const bool any = best.row != 0x7fffffff;
    int32_t* o = P.table +
                 (((size_t)(P.step & 1) * P.shards + P.shard) * P.b + lane) *
                     OFFER_WORDS;
    o[0] = __float_as_int(best.val);
    o[1] = any ? best.row + P.off : 0x7fffffff;
    o[2] = __float_as_int(best.bin);
    o[3] = best.pre;
    o[4] = cnt[0];
    o[5] = cnt[1];
    o[6] = cnt[2];
    // The spread values of this shard's best row, for its owner's offer.
    for (int s = 0; s < MAX_S; ++s) {
      int ss = ri[RI_S_SLOT + s];
      ss = ss < 0 ? 0 : ss;
      if (ss >= P.m.a) ss = P.m.a - 1;
      o[7 + s] = any ? P.m.attr_hash[(size_t)best.row * P.m.a + ss] : 0;
    }
    for (int w = 7 + MAX_S; w < OFFER_WORDS; ++w) o[w] = 0;
  }
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

// {lane state words, usage-table entries} for a shard of n rows.
extern "C" int nomad_sharded_place_shape(int n, int d, int p, long long* out) {
  out[0] = sp_lane_words(n, d, p);
  out[1] = sp_umax(d, p);
  return 2;
}

extern "C" int nomad_sharded_place(
    const float* totals, const float* used, const uint8_t* eligible,
    const int32_t* attr_hash, const float* attr_num, const float* attr_ver,
    const int32_t* class_id, const int32_t* dev_total, const int32_t* dev_used,
    const float* prio_used, const int32_t* port_words, const int32_t* dyn_used,
    const int32_t* delta_rows, const float* delta_vals,
    const int32_t* tg_counts, const float* spread_counts,
    const uint8_t* penalties, const int32_t* req_i, const float* req_f,
    const uint8_t* class_eligs, const uint8_t* host_masks,
    const uint8_t* lane_mask, int32_t* table, int32_t* state, float* out,
    int n, int a, int w, int row_offset, int b, int d, int k, int p,
    int shards, int shard, int step, int c_width, int a_width, int s_width,
    int preempt, int ports, cudaStream_t stream) {
  if (p > SP_MAX_PLACEMENTS || p < 1 || step < 0 || step > p || n <= 0 ||
      b <= 0 || k <= 0 || a <= 0 || d < 0 || d > MAX_LANE_DELTAS ||
      row_offset < 0 || shards < 1 || shard < 0 || shard >= shards ||
      c_width < 0 || c_width > MAX_C || a_width < 0 || a_width > MAX_A ||
      s_width < 0 || s_width > MAX_S)
    return (int)cudaErrorInvalidValue;
  SPParams P;
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
  P.table = table;
  P.state = state;
  P.out = out;
  P.n = n;
  P.off = row_offset;
  P.b = b;
  P.d = d;
  P.k = k;
  P.p = p;
  P.shards = shards;
  P.shard = shard;
  P.step = step;
  P.umax = sp_umax(d, p);
  P.lane_words = sp_lane_words(n, d, p);
  P.rw = {c_width, a_width, s_width, preempt, ports};
  if (widths_tier(P.rw) == 0)
    sharded_place_kernel<WidthsBench><<<b, SP_THREADS, 0, stream>>>(P);
  else
    sharded_place_kernel<WidthsFull><<<b, SP_THREADS, 0, stream>>>(P);
  return (int)cudaGetLastError();
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
