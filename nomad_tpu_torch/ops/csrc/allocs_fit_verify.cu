// allocs_fit_verify — the cross-lane AllocsFit scan and the pack epilogue.
//
// Replaces the tail of the JAX megakernel
// nomad_tpu/ops/kernels.py:_fused_place_batch_impl: the lax.scan over lanes
// (kernels.py:1026-1049) and pack_fused_lanes (kernels.py:942).
//
// Lanes are taken in order.  Each live lane adds its in-flight deltas into a
// cumulative usage, then commits its placements one by one and checks
// u[row] <= totals[row] on all three dimensions (p_step, kernels.py:1037).
// Dead lanes contribute nothing and read row -1, zeros and VERIFIED -1.0.
// The float32 additions happen in the same order as the JAX scan, so the
// column is bit-identical to it.
//
// What bounds it: latency.  The scan is sequential — B·(D + P) dependent
// row updates, each a read-modify-write of one (3,) row — so it runs on a
// single thread with the (N, 3) carry in device memory; the rest of the
// block only copies `used` into the carry and the first seven columns into
// the output.  Its bytes (the carry's copy, the packed columns) are
// negligible next to the dependent-load chain.  Keeping the touched rows in
// shared memory is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "layout.cuh"

#define THREADS 1024

__global__ void __launch_bounds__(THREADS)
allocs_fit_verify_kernel(const float* __restrict__ totals,
                         const float* __restrict__ used,
                         const float* __restrict__ packed,
                         const float* __restrict__ req_f,
                         const int32_t* __restrict__ delta_rows,
                         const float* __restrict__ delta_vals,
                         const uint8_t* __restrict__ lane_mask,
                         float* __restrict__ out, float* __restrict__ cum,
                         int n, int b, int p, int d) {
  const int tid = threadIdx.x;
  for (int i = tid; i < n * 3; i += THREADS) cum[i] = used[i];
  // Columns 0-6, with the dead-lane pack (pack_fused_lanes).
  for (int i = tid; i < b * p * PACKED_WIDTH; i += THREADS) {
    const int lane = i / (p * PACKED_WIDTH);
    const int col = i % PACKED_WIDTH;
    const int step = (i / PACKED_WIDTH) % p;
    const float v = lane_mask[lane] ? packed[i] : (col == 0 ? -1.0f : 0.0f);
    out[((size_t)lane * p + step) * FUSED_PACKED_WIDTH + col] = v;
  }
  __syncthreads();
  if (tid != 0) return;

  for (int lane = 0; lane < b; ++lane) {
    float* o = out + (size_t)lane * p * FUSED_PACKED_WIDTH;
    if (!lane_mask[lane]) {
      for (int s = 0; s < p; ++s) o[s * FUSED_PACKED_WIDTH + 7] = -1.0f;
      continue;
    }
    for (int j = 0; j < d; ++j) {
      const int r = delta_rows[(size_t)lane * d + j];
      if (r < 0 || r >= n) continue;
      for (int c = 0; c < 3; ++c)
        cum[r * 3 + c] += delta_vals[((size_t)lane * d + j) * 3 + c];
    }
    const float* ask = req_f + (size_t)lane * REQ_FLOAT_WIDTH + RF_ASK;
    for (int s = 0; s < p; ++s) {
      const int r = (int)packed[((size_t)lane * p + s) * PACKED_WIDTH];
      float verdict = 1.0f;
      if (r >= 0 && r < n) {
        bool fit = true;
        for (int c = 0; c < 3; ++c) {
          const float v = cum[r * 3 + c] + ask[c];
          cum[r * 3 + c] = v;
          fit = fit && v <= totals[r * 3 + c];
        }
        verdict = fit ? 1.0f : 0.0f;
      }
      o[s * FUSED_PACKED_WIDTH + 7] = verdict;
    }
  }
}

extern "C" int nomad_allocs_fit_verify(const float* totals, const float* used,
                                       const float* packed, const float* req_f,
                                       const int32_t* delta_rows,
                                       const float* delta_vals,
                                       const uint8_t* lane_mask, float* out,
                                       float* cum, int n, int b, int p, int d,
                                       cudaStream_t stream) {
  if (n <= 0 || b <= 0 || p <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  allocs_fit_verify_kernel<<<1, THREADS, 0, stream>>>(
      totals, used, packed, req_f, delta_rows, delta_vals, lane_mask, out, cum,
      n, b, p, d);
  return (int)cudaGetLastError();
}
