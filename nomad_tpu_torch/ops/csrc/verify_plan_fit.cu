// verify_plan_fit — the plan applier's AllocsFit re-check, one verdict a
// plan row.
//
// Replaces nomad_tpu/ops/kernels.py:verify_plan_fit (:1077): for each plan
// row j with node row r = max(rows[j], 0), used[r] + deltas[j] <= totals[r]
// on all three dimensions, and the node eligible where the row places new
// allocations (eligible_required[j]); a padding row (rows[j] < 0) passes.
// A row past the matrix reads its last row, as JAX's gather clamps.
// The output is (K,) torch.bool: every byte exactly 0 or 1.
//
// Design: one thread per plan row: three float32 adds and compares, two
// byte reads, one byte written.
//
// What bounds it on an H100: launch latency.  A row moves about 42 bytes
// (the row index, its delta, elig_required, its node's used and totals
// and eligible byte, the verdict): 0.42 MB at K=10,000, about 0.1 us at
// 3.35 TB/s, far under the few microseconds a launch takes.
//
// Numerics: one float32 add and one compare per dimension (built with
// -fmad=false, nothing to fuse), bit-identical to the plain PyTorch
// version and to the applier's numpy check (server/plan_apply.py
// host_verify).

#include <cuda_runtime.h>
#include <stdint.h>

#include "layout.cuh"

#define THREADS 256

__global__ void __launch_bounds__(THREADS)
verify_plan_fit_kernel(const float* __restrict__ used,
                       const float* __restrict__ totals,
                       const uint8_t* __restrict__ eligible,
                       const int32_t* __restrict__ rows,
                       const float* __restrict__ deltas,
                       const uint8_t* __restrict__ elig_required,
                       uint8_t* __restrict__ out, int k, int n) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= k) return;
  const int row = rows[j];
  const int r = row < 0 ? 0 : (row >= n ? n - 1 : row);
  const size_t q = (size_t)r * 3, d = (size_t)j * 3;
  const bool fits = used[q] + deltas[d] <= totals[q] &&
                    used[q + 1] + deltas[d + 1] <= totals[q + 1] &&
                    used[q + 2] + deltas[d + 2] <= totals[q + 2];
  const bool ok = fits && (elig_required[j] == 0 || eligible[r] != 0);
  out[j] = (row < 0 || ok) ? 1 : 0;
}

extern "C" int nomad_verify_plan_fit(const float* used, const float* totals,
                                     const uint8_t* eligible,
                                     const int32_t* rows, const float* deltas,
                                     const uint8_t* elig_required,
                                     uint8_t* out, int k, int n,
                                     cudaStream_t stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (k + THREADS - 1) / THREADS;
  verify_plan_fit_kernel<<<blocks, THREADS, 0, stream>>>(
      used, totals, eligible, rows, deltas, elig_required, out, k, n);
  return (int)cudaGetLastError();
}
