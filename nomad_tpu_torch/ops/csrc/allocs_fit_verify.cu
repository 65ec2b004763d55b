// allocs_fit_verify — the cross-lane AllocsFit scan and the pack epilogue.
//
// Replaces the tail of the JAX megakernel
// nomad_tpu/ops/kernels.py:_fused_place_batch_impl: the lax.scan over lanes
// (kernels.py:1026-1049) and pack_fused_lanes (kernels.py:942).
//
// What it computes.  Lanes are taken in order.  Each live lane adds its
// in-flight deltas into a cumulative usage, then commits its placements
// one by one and checks u[row] <= totals[row] on all three dimensions
// (p_step, kernels.py:1037); a placement adds its ask whether it fits or
// not.  Dead lanes contribute nothing and read row -1, zeros and VERIFIED
// -1.0; a live lane's pick with no row (row < 0 or >= n) reads 1.0.
//
// Design: a row-segmented scan.  A verdict depends only on the earlier
// events on the same row, so rows are independent.  Every event — a delta
// row or a pick of a live lane, on a row in [0, n) — gets the sequence
// number lane·(D + P) + j (deltas j < D, picks D + step), which is the
// order the reference adds in.  One CTA of 1,024 threads:
//   1. reads every candidate event's row (24 warps) while the other warps
//      write the pack (columns 0-6, the dead-lane pack, the verdicts no
//      row decides), one pick a thread, with coalesced stores;
//   2. keeps the events with an effect, in sequence order (a ballot per
//      32 candidates), and sorts them stably by row with an LSD radix
//      sort of up to 8-bit digits (two passes at N = 10,240): ranks within
//      a warp from one ballot per digit bit, per-warp digit counts, one
//      block-wide scan per pass;
//   3. gathers each sorted event's three values (a delta's, or the lane's
//      ask), its output slot and its row's totals side by side; a row
//      segment's first event carries used[r] plus its values, the row's
//      first addition;
//   4. walks the segments: one lane walks a segment of at most SHORT_RUN
//      events; for a longer one, lane c < 3 of its warp adds dimension c
//      of every event in order — each row's additions in the reference's
//      order, so the column is bit-identical.
// No (N, 3) carry and no copy of `used`.
//
// The row window (the node-sharded verify, nomad_tpu/parallel/
// sharding.py:590-640).  `totals` and `used` may be one node shard's rows
// [row_offset, row_offset + n) of the matrix; rows in `packed` and in the
// deltas stay global.  Events outside the window have no effect and a
// pick outside it fits vacuously (1.0).  A launch may also take the
// verdict columns of the other shards (`and_with`, (S', B·P) floats), and
// its last pass writes the least verdict of each pick over all of them:
// the cross-shard AND, so each row's owner alone can veto.  The unsharded
// launch is the window [0, n) with no other columns.  Each thread issues the loads of
// a phase before it uses any of them, so a phase costs one memory round
// trip.
//
// Two tiers, one algorithm: the event arrays (two key buffers of (row,
// sequence), the gathered quad pairs, the lanes' asks; 48 bytes an event)
// live in dynamic shared memory while they fit it (3,072 events, 147 KB,
// at the bench's B=64, D=32, P=16), and otherwise in a device scratch the
// wrapper passes (66,560 events at B=64 and D = MAX_LANE_DELTAS); the
// digit counts stay in shared memory.
//
// What bounds it on an H100: latency.  Its bytes (the touched rows, the
// deltas, the packed columns in and out) are well under a microsecond at
// 3.35 TB/s; the time is a few memory round trips, the radix passes'
// barriers and shared-memory round trips, and the longest row segment,
// which is serial by nature (three dependent additions an event there).

#include <cuda_runtime.h>
#include <stdint.h>

#include "layout.cuh"
#include "per_device.cuh"

#define THREADS 1024
#define WARPS (THREADS / 32)
#define VERIFIED_COL 7  // kernels.FUSED_PACKED_VERIFIED
#define MAX_DIGIT_BITS 8
#define HSTRIDE (WARPS + 1)  // a digit's row of per-warp counts, padded
// Counts a thread scans: 2^MAX_DIGIT_BITS · HSTRIDE / THREADS, rounded up.
#define SCAN_PER (((1 << MAX_DIGIT_BITS) * HSTRIDE + THREADS - 1) / THREADS)
#define UNROLL 4  // items a thread loads before it uses them
#define CAND_WARPS 24  // warps that read the candidate events in phase 1
#define SHORT_RUN 8  // a segment this long or shorter is walked by one lane
// H100: the dynamic shared memory one CTA may use.
#define SMEM_LIMIT 232448

struct VerifyPlan {
  int tier;          // 0: event arrays in shared memory, 1: in device scratch
  int passes;        // radix passes over the row bits
  int digit_bits;    // bits a pass sorts
  long long events;  // B·(D + P) candidate events
  long long smem;    // dynamic shared memory bytes
  long long scratch; // device scratch bytes (tier 1)
};

// Ints of the event arrays: two key buffers (rows, sequence numbers), the
// gathered pairs of quads ((value x3, output slot), (row totals x3, -)),
// the lanes' asks.
static long long event_ints(long long cand, int b) {
  return 12 * cand + 3LL * b;
}

// Ints of the fixed shared part: two digit-count buffers, the warps'
// partial sums, the candidate warps' event counts.
static long long fixed_ints(int digit_bits) {
  return 2LL * (1 << digit_bits) * HSTRIDE + WARPS + 32;
}

static VerifyPlan plan_of(int n, int b, int p, int d) {
  VerifyPlan pl;
  const int bits = n > 1 ? 32 - __builtin_clz((unsigned)(n - 1)) : 0;
  pl.passes = bits ? (bits + MAX_DIGIT_BITS - 1) / MAX_DIGIT_BITS : 1;
  pl.digit_bits = bits ? (bits + pl.passes - 1) / pl.passes : 1;
  pl.events = (long long)b * (d + p);
  const long long fixed = fixed_ints(pl.digit_bits) * 4;
  const long long arrays = event_ints(pl.events, b) * 4;
  if (fixed + arrays <= SMEM_LIMIT) {
    pl.tier = 0;
    pl.smem = fixed + arrays;
    pl.scratch = 0;
  } else {
    pl.tier = 1;
    pl.smem = fixed;
    pl.scratch = arrays;
  }
  return pl;
}

struct Inputs {
  const float* totals;
  const float* used;
  const float* packed;
  const float* req_f;
  const int32_t* delta_rows;
  const float* delta_vals;
  const uint8_t* lane_mask;
  const float* and_with;  // (n_and, B·P) other shards' verdicts, or null
  int n, b, p, d;
  int off, n_and;         // the window's first global row; and_with rows
};

// One half of a stable radix pass over `count` events.  Warp w takes the
// events [w·span, (w+1)·span) in order, 32 at a time; events with the
// same digit rank among themselves by lane, so the order within a digit
// is the input order.  The lanes holding a digit are found by one ballot
// per digit bit (a warp multisplit).  hist[digit·HSTRIDE + w] is the
// warp's running count (counting half) or its running output offset
// (scatter half); the padded stride puts a warp's digits on distinct
// shared-memory banks.
template <bool SCATTER>
__device__ __forceinline__ void radix_half(int count, const int* src_row,
                                           const int* src_seq, int* dst_row,
                                           int* dst_seq, int* hist, int shift,
                                           int bits) {
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const unsigned below = (1u << ln) - 1u;
  const int span = (count + WARPS - 1) / WARPS;
  const int beg = w * span;
  const int end = min(count, beg + span);
  for (int base = beg; base < end; base += 32) {
    const int i = base + ln;
    const bool valid = i < end;
    const int row = valid ? src_row[i] : 0;
    const int seq = valid ? src_seq[i] : 0;
    const int digit = (row >> shift) & ((1 << bits) - 1);
    const unsigned live = __ballot_sync(0xffffffffu, valid);
    unsigned peers = valid ? live : ~live;
#pragma unroll
    for (int b = 0; b < MAX_DIGIT_BITS; ++b) {
      if (b < bits) {
        const unsigned set = __ballot_sync(0xffffffffu, (digit >> b) & 1);
        peers &= ((digit >> b) & 1) ? set : ~set;
      }
    }
    const int rank = __popc(peers & below);
    const int slot = digit * HSTRIDE + w;
    const int cur = valid ? hist[slot] : 0;
    if (SCATTER && valid) {
      dst_row[cur + rank] = row;
      dst_seq[cur + rank] = seq;
    }
    __syncwarp();
    if (valid && rank == 0) hist[slot] = cur + __popc(peers);
    __syncwarp();
  }
}

// Exclusive prefix sum of a[0..len) in place, by the whole block, `len` at
// most SCAN_PER·THREADS.  `sums` holds WARPS ints.
__device__ void block_exclusive_scan(int* a, int len, int* sums) {
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int per = (len + THREADS - 1) / THREADS;
  const int beg = threadIdx.x * per;
  int v[SCAN_PER];
  int own = 0;
#pragma unroll
  for (int k = 0; k < SCAN_PER; ++k) {
    v[k] = (k < per && beg + k < len) ? a[beg + k] : 0;
    own += v[k];
  }
  int x = own;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (ln >= o) x += y;
  }
  if (ln == 31) sums[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = sums[ln];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (ln >= o) s += y;
    }
    sums[ln] = s;
  }
  __syncthreads();
  int run = (w ? sums[w - 1] : 0) + x - own;
#pragma unroll
  for (int k = 0; k < SCAN_PER; ++k) {
    if (k < per && beg + k < len) a[beg + k] = run;
    run += v[k];
  }
  __syncthreads();
}

// SMEM: the event arrays are in shared memory (tier 0), else in `scratch`.
template <bool SMEM>
__global__ void __launch_bounds__(THREADS, 1)
allocs_fit_verify_kernel(Inputs in, float* __restrict__ out,
                         int* __restrict__ scratch, int passes,
                         int digit_bits) {
  extern __shared__ __align__(16) int smem[];
  const int tid = threadIdx.x, w = tid >> 5, ln = tid & 31;
  const unsigned below = (1u << ln) - 1u;
  const int nb = 1 << digit_bits;
  int* hist = smem;                      // 2 buffers of nb·HSTRIDE counts
  int* sums = hist + 2 * nb * HSTRIDE;   // WARPS partial sums
  int* wcount = sums + WARPS;            // the candidate warps' counts
  const int stride = in.d + in.p;
  const int cand = in.b * stride;
  // ev: key buffers 0 and 1 (rows, then sequence numbers; cand each), the
  // gathered quad pairs (8·cand, 16-byte aligned), the asks (3·B).
  int* ev = SMEM ? wcount + 32 : scratch;
  float4* gathered = reinterpret_cast<float4*>(ev + 4 * cand);
  float* asks = reinterpret_cast<float*>(ev + 12 * cand);

  // Phase 1, one memory round trip.  Candidate warp w reads the events
  // [w·span, (w+1)·span) in sequence order, writes each one's row (-1: no
  // effect) into key buffer 1 and counts those with an effect; the other
  // warps write the pack, one pick a thread, and stage the lanes' asks.
  const int cspan = ((cand + CAND_WARPS - 1) / CAND_WARPS + 31) & ~31;
  if (w < CAND_WARPS) {
    const int beg = w * cspan, end = min(cand, beg + cspan);
    int kept = 0;
    for (int base = beg; base < end; base += UNROLL * 32) {
      int row[UNROLL];
      bool live[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = base + u * 32 + ln;
        row[u] = -1;
        live[u] = false;
        if (c < end) {
          const int lane = c / stride;
          const int j = c - lane * stride;
          live[u] = in.lane_mask[lane] != 0;
          row[u] = j < in.d
                       ? in.delta_rows[(size_t)lane * in.d + j]
                       : (int)in.packed[((size_t)lane * in.p + (j - in.d)) *
                                        PACKED_WIDTH];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = base + u * 32 + ln;
        const int lr = row[u] - in.off;  // the row inside the window
        const bool keep = live[u] && lr >= 0 && lr < in.n;
        kept += __popc(__ballot_sync(0xffffffffu, keep));
        if (c < end) ev[2 * cand + c] = keep ? lr : -1;
      }
    }
    if (ln == 0) wcount[w] = kept;
  } else {
    const int pt = THREADS - CAND_WARPS * 32;
    const int picks = in.b * in.p;
    for (int q0 = tid - CAND_WARPS * 32; q0 < picks; q0 += UNROLL * pt) {
      float v[UNROLL][PACKED_WIDTH], ask[UNROLL][3];
      bool live[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int q = q0 + u * pt;
        live[u] = false;
        if (q < picks) {
          const float* src = in.packed + (size_t)q * PACKED_WIDTH;
#pragma unroll
          for (int c = 0; c < PACKED_WIDTH; ++c) v[u][c] = src[c];
          const int lane = q / in.p;
          live[u] = in.lane_mask[lane] != 0;
          // The lane's first pick stages its ask.
          if (q == lane * in.p) {
            const float* a =
                in.req_f + (size_t)lane * REQ_FLOAT_WIDTH + RF_ASK;
            ask[u][0] = a[0];
            ask[u][1] = a[1];
            ask[u][2] = a[2];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int q = q0 + u * pt;
        if (q >= picks) continue;
        const int lane = q / in.p;
        if (q == lane * in.p) {
          asks[3 * lane] = ask[u][0];
          asks[3 * lane + 1] = ask[u][1];
          asks[3 * lane + 2] = ask[u][2];
        }
        if (!live[u]) {
          v[u][0] = -1.0f;
#pragma unroll
          for (int c = 1; c < PACKED_WIDTH; ++c) v[u][c] = 0.0f;
        }
        float* o = out + (size_t)q * FUSED_PACKED_WIDTH;
        *reinterpret_cast<float4*>(o) =
            make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
        *reinterpret_cast<float2*>(o + 4) = make_float2(v[u][4], v[u][5]);
        o[6] = v[u][6];
        // Verdicts no row decides; the walk writes the others.
        const int r = (int)v[u][0] - in.off;
        if (!live[u])
          o[VERIFIED_COL] = -1.0f;
        else if (r < 0 || r >= in.n)
          o[VERIFIED_COL] = 1.0f;
      }
    }
  }
  // Both digit-count buffers start at zero; a pass zeroes its buffer again
  // for the pass after next.
  for (int i = tid; i < 2 * nb * HSTRIDE; i += THREADS) hist[i] = 0;
  __syncthreads();

  // Compaction, in sequence order: candidate warp w writes its events with
  // an effect (row, sequence number) into key buffer 0 after those of the
  // warps before it.
  int count;
  {
    const int c = ln < CAND_WARPS ? wcount[ln] : 0;
    int x = c;  // inclusive scan of the counts over the lanes
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (ln >= o) x += y;
    }
    count = __shfl_sync(0xffffffffu, x, 31);
    int before = __shfl_sync(0xffffffffu, x - c, w);
    if (w < CAND_WARPS) {
      const int beg = w * cspan, end = min(cand, beg + cspan);
      for (int base = beg; base < end; base += 32) {
        const int c1 = base + ln;
        const int row = c1 < end ? ev[2 * cand + c1] : -1;
        const unsigned keep = __ballot_sync(0xffffffffu, row >= 0);
        if (row >= 0) {
          const int at = before + __popc(keep & below);
          ev[at] = row;
          ev[cand + at] = c1;
        }
        before += __popc(keep);
      }
    }
  }
  __syncthreads();

  // Stable LSD radix sort of the events by row, from key buffer 0.
  int cur = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * digit_bits;
    int* h = hist + (pass & 1) * nb * HSTRIDE;
    const int* src = ev + cur * 2 * cand;
    int* dst = ev + (cur ^ 1) * 2 * cand;
    radix_half<false>(count, src, src + cand, nullptr, nullptr, h, shift,
                      digit_bits);
    __syncthreads();
    block_exclusive_scan(h, nb * HSTRIDE, sums);
    radix_half<true>(count, src, src + cand, dst, dst + cand, h, shift,
                     digit_bits);
    __syncthreads();
    if (pass + 2 < passes)
      for (int i = tid; i < nb * HSTRIDE; i += THREADS) h[i] = 0;
    cur ^= 1;
  }
  const int* rows = ev + cur * 2 * cand;
  const int* seqs = rows + cand;

  // Each sorted event's values and output slot (-1: a delta), and its
  // row's totals, side by side.  A segment's first event carries
  // used[r] + its values: the first addition of the row.
  for (int i0 = tid; i0 < count; i0 += UNROLL * THREADS) {
    float4 g[UNROLL], t[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < count) {
        const int r = rows[i];
        const int seq = seqs[i];
        const int lane = seq / stride;
        const int e = seq - lane * stride;
        const float* v = e < in.d
                             ? in.delta_vals + ((size_t)lane * in.d + e) * 3
                             : asks + 3 * lane;
        g[u] = make_float4(v[0], v[1], v[2],
                           __int_as_float(e < in.d ? -1
                                                   : lane * in.p + (e - in.d)));
        t[u] = make_float4(in.totals[(size_t)r * 3],
                           in.totals[(size_t)r * 3 + 1],
                           in.totals[(size_t)r * 3 + 2], 0.f);
        if (i == 0 || rows[i - 1] != r) {
          g[u].x = in.used[(size_t)r * 3] + g[u].x;
          g[u].y = in.used[(size_t)r * 3 + 1] + g[u].y;
          g[u].z = in.used[(size_t)r * 3 + 2] + g[u].z;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < count) {
        gathered[2 * i] = g[u];
        gathered[2 * i + 1] = t[u];
      }
    }
  }
  __syncthreads();

  // The walk.  Warp w takes the segments whose first event lies in its
  // share of the sorted events.  The additions start from -0.0, the
  // additive identity (a segment's first event carries used[r]).  A
  // segment of at most SHORT_RUN events is walked by the lane that holds
  // its first event, which checks the usage after each pick against the
  // row's totals and writes the verdict.  A longer one is walked by its
  // warp: lane c < 3 adds dimension c of every event in sequence order,
  // and the warp writes the verdicts 32 at a time.
  {
    const int span = (count + WARPS - 1) / WARPS;
    const int beg = w * span;
    const int stop = min(count, beg + span);
    for (int base = beg; base < stop; base += 32) {
      const int i = base + ln;
      const bool head = i < stop && (i == 0 || rows[i - 1] != rows[i]);
      int run = 0;
      if (head) {
        const int r = rows[i];
        bool same[SHORT_RUN];
#pragma unroll
        for (int k = 0; k < SHORT_RUN; ++k)
          same[k] = i + 1 + k < count && rows[i + 1 + k] == r;
        run = 1;
#pragma unroll
        for (int k = 0; k < SHORT_RUN; ++k)
          if (run == k + 1 && same[k]) run = k + 2;
      }
      if (head && run <= SHORT_RUN) {
        float u0 = -0.0f, u1 = -0.0f, u2 = -0.0f;
#pragma unroll
        for (int k = 0; k < SHORT_RUN; ++k) {
          if (k < run) {
            const float4 g = gathered[2 * (i + k)];
            const float4 t = gathered[2 * (i + k) + 1];
            u0 += g.x;
            u1 += g.y;
            u2 += g.z;
            const int slot = __float_as_int(g.w);
            if (slot >= 0)
              out[(size_t)slot * FUSED_PACKED_WIDTH + VERIFIED_COL] =
                  (u0 <= t.x && u1 <= t.y && u2 <= t.z) ? 1.0f : 0.0f;
          }
        }
      }
      unsigned longs = __ballot_sync(0xffffffffu, head && run > SHORT_RUN);
      while (longs) {
        const int h = base + __ffs(longs) - 1;
        longs &= longs - 1;
        const int r = rows[h];
        int end = h;
        for (;;) {
          const int j = end + ln;
          const int len = __popc(
              __ballot_sync(0xffffffffu, j < count && rows[j] == r));
          end += len;
          if (len < 32) break;
        }
        // Lane c < 3 adds dimension c of the events in sequence order, 32
        // at a time, keeping a bit for each event whose usage fits; the
        // lanes then combine the three masks, and lane k writes the verdict
        // of the block's event k.
        const float* gf = reinterpret_cast<const float*>(gathered);
        float u = -0.0f;
        for (int blk = h; blk < end; blk += 32) {
          const int len = min(32, end - blk);
          unsigned fit = 0u;
          if (ln < 3) {
#pragma unroll 8
            for (int e = 0; e < len; ++e) {
              u += gf[8 * (blk + e) + ln];
              fit |= (u <= gf[8 * (blk + e) + 4 + ln] ? 1u : 0u) << e;
            }
          }
          fit = __shfl_sync(0xffffffffu, fit, 0) &
                __shfl_sync(0xffffffffu, fit, 1) &
                __shfl_sync(0xffffffffu, fit, 2);
          const int j = blk + ln;
          if (ln < len) {
            const int slot = __float_as_int(gf[8 * j + 3]);
            if (slot >= 0)
              out[(size_t)slot * FUSED_PACKED_WIDTH + VERIFIED_COL] =
                  ((fit >> ln) & 1u) ? 1.0f : 0.0f;
          }
        }
      }
    }
  }
  // The cross-shard AND: each pick's least verdict over this launch's
  // window and the other shards' columns.
  if (in.n_and > 0) {
    __syncthreads();
    const int picks = in.b * in.p;
    for (int q = tid; q < picks; q += THREADS) {
      float v = out[(size_t)q * FUSED_PACKED_WIDTH + VERIFIED_COL];
      for (int s = 0; s < in.n_and; ++s)
        v = fminf(v, in.and_with[(size_t)s * picks + q]);
      out[(size_t)q * FUSED_PACKED_WIDTH + VERIFIED_COL] = v;
    }
  }
}

// The launch plan for these sizes: out[0] tier, [1] passes, [2] digit
// bits, [3] candidate events, [4] dynamic shared memory bytes, [5] device
// scratch bytes (0 in tier 0).
extern "C" int nomad_allocs_fit_verify_shape(int n, int b, int p, int d,
                                             long long* out) {
  const VerifyPlan pl = plan_of(n, b, p, d);
  out[0] = pl.tier;
  out[1] = pl.passes;
  out[2] = pl.digit_bits;
  out[3] = pl.events;
  out[4] = pl.smem;
  out[5] = pl.scratch;
  return 0;
}

extern "C" int nomad_allocs_fit_verify(const float* totals, const float* used,
                                       const float* packed, const float* req_f,
                                       const int32_t* delta_rows,
                                       const float* delta_vals,
                                       const uint8_t* lane_mask, float* out,
                                       int32_t* scratch, const float* and_with,
                                       int n, int b, int p, int d,
                                       int row_offset, int n_and,
                                       cudaStream_t stream) {
  if (n <= 0 || b <= 0 || p <= 0 || d < 0 || row_offset < 0 || n_and < 0 ||
      (n_and > 0 && and_with == nullptr))
    return (int)cudaErrorInvalidValue;
  const VerifyPlan pl = plan_of(n, b, p, d);
  if (pl.tier == 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  // Both tiers may pass 48 KB of dynamic shared memory (tier 1's digit
  // counts alone take 66 KB at 8-bit digits).
  static bool configured[2][NOMAD_MAX_DEVICES];
  {
    cudaError_t err = nomad_smem_once(
        configured[0], allocs_fit_verify_kernel<true>, SMEM_LIMIT);
    if (err == cudaSuccess)
      err = nomad_smem_once(configured[1], allocs_fit_verify_kernel<false>,
                            SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
  }
  Inputs in{totals,     used,  packed, req_f,      delta_rows, delta_vals,
            lane_mask,  and_with, n,   b,          p,          d,
            row_offset, n_and};
  if (pl.tier == 0)
    allocs_fit_verify_kernel<true><<<1, THREADS, (size_t)pl.smem, stream>>>(
        in, out, nullptr, pl.passes, pl.digit_bits);
  else
    allocs_fit_verify_kernel<false><<<1, THREADS, (size_t)pl.smem, stream>>>(
        in, out, scratch, pl.passes, pl.digit_bits);
  return (int)cudaGetLastError();
}
