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
// What bounds it on an H100: latency.  A row moves about 42 bytes (the
// row index, its delta, elig_required, its node's used and totals and
// eligible byte, the verdict): 0.42 MB at K=10,000, about 0.1 us at
// 3.35 TB/s, far under a launch and the two dependent memory round trips
// (the row index, then the node's gathers) that every row needs.  The
// first design ran one row a thread in CTAs of 256 (40 CTAs at K=10,000,
// under a third of the card), three scalar loads per 12-byte row of
// deltas, used and totals, and one byte stored a thread.
//
// Design: VP_ROWS rows a thread; CTAs sized so that the grid spreads over
// every SM (16 to 256 threads).  A thread loads its rows' indices,
// deltas and elig_required with 16- and 4-byte loads, issues the gathers
// of used, totals and eligible of all its rows together right after, and
// stores its verdicts as one 32-bit word.  A thread at the ragged end, or
// operands not aligned for the wide accesses, take the scalar path.
//
// Numerics: one float32 add and one compare per dimension (built with
// -fmad=false, nothing to fuse), bit-identical to the plain PyTorch
// version and to the applier's numpy check (server/plan_apply.py
// host_verify).

#include <cuda_runtime.h>
#include <stdint.h>

#include "layout.cuh"
#include "per_device.cuh"

#define VP_ROWS 4
#define VP_MIN_THREADS 16
#define VP_MAX_THREADS 256

// Minimum one CTA an SM: room for the registers that keep every gather of
// a thread's rows in flight together (the default budget of 32 registers
// made the compiler issue them a few at a time).
__global__ void __launch_bounds__(VP_MAX_THREADS, 1)
verify_plan_fit_kernel(const float* __restrict__ used,
                       const float* __restrict__ totals,
                       const uint8_t* __restrict__ eligible,
                       const int32_t* __restrict__ rows,
                       const float* __restrict__ deltas,
                       const uint8_t* __restrict__ elig_required,
                       uint8_t* __restrict__ out, int k, int n, int vec) {
  const int j0 = (blockIdx.x * blockDim.x + threadIdx.x) * VP_ROWS;
  if (j0 >= k) return;
  const bool wide = vec && j0 + VP_ROWS <= k;
  int row[VP_ROWS];
  float d[3 * VP_ROWS];
  uint8_t req[VP_ROWS];
  if (wide) {
    const int4 r4 = __ldg(reinterpret_cast<const int4*>(rows + j0));
    row[0] = r4.x;
    row[1] = r4.y;
    row[2] = r4.z;
    row[3] = r4.w;
    const float4* d4 = reinterpret_cast<const float4*>(deltas + (size_t)j0 * 3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 x = __ldg(d4 + i);
      d[4 * i] = x.x;
      d[4 * i + 1] = x.y;
      d[4 * i + 2] = x.z;
      d[4 * i + 3] = x.w;
    }
    const uchar4 e4 =
        __ldg(reinterpret_cast<const uchar4*>(elig_required + j0));
    req[0] = e4.x;
    req[1] = e4.y;
    req[2] = e4.z;
    req[3] = e4.w;
  } else {
#pragma unroll
    for (int i = 0; i < VP_ROWS; ++i) {
      const int j = j0 + i;
      const bool in = j < k;
      row[i] = in ? __ldg(rows + j) : -1;
      req[i] = in ? __ldg(elig_required + j) : 0;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        d[3 * i + c] = in ? __ldg(deltas + (size_t)j * 3 + c) : 0.0f;
    }
  }
  // Every gather of every row, issued together.
  float u[3 * VP_ROWS], t[3 * VP_ROWS];
  uint8_t el[VP_ROWS];
#pragma unroll
  for (int i = 0; i < VP_ROWS; ++i) {
    const int r = row[i] < 0 ? 0 : (row[i] >= n ? n - 1 : row[i]);
    const size_t q = (size_t)r * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u[3 * i + c] = __ldg(used + q + c);
      t[3 * i + c] = __ldg(totals + q + c);
    }
    el[i] = __ldg(eligible + r);
  }
  uint32_t verdicts = 0;
#pragma unroll
  for (int i = 0; i < VP_ROWS; ++i) {
    const bool fits = u[3 * i] + d[3 * i] <= t[3 * i] &&
                      u[3 * i + 1] + d[3 * i + 1] <= t[3 * i + 1] &&
                      u[3 * i + 2] + d[3 * i + 2] <= t[3 * i + 2];
    const bool ok = fits && (req[i] == 0 || el[i] != 0);
    verdicts |= (uint32_t)(row[i] < 0 || ok) << (8 * i);
  }
  if (wide) {
    *reinterpret_cast<uint32_t*>(out + j0) = verdicts;
  } else {
#pragma unroll
    for (int i = 0; i < VP_ROWS; ++i)
      if (j0 + i < k) out[j0 + i] = (uint8_t)((verdicts >> (8 * i)) & 1u);
  }
}

// cols: the matrix's used, totals and eligible device pointers.
extern "C" int nomad_verify_plan_fit(const void* const* cols,
                                     const int32_t* rows, const float* deltas,
                                     const uint8_t* elig_required,
                                     uint8_t* out, int k, int n,
                                     cudaStream_t stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const float* used = static_cast<const float*>(cols[0]);
  const float* totals = static_cast<const float*>(cols[1]);
  const uint8_t* eligible = static_cast<const uint8_t*>(cols[2]);
  // CTA width: the largest power of two (16 to 256) that still gives
  // every SM a CTA, so a small plan spreads over the card.
  const int threads = (k + VP_ROWS - 1) / VP_ROWS;
  const int sms = nomad_sm_count();
  const int per_sm = (threads + sms - 1) / sms;
  int width = VP_MIN_THREADS;
  while (width * 2 <= per_sm && width < VP_MAX_THREADS) width *= 2;
  const int vec = ((reinterpret_cast<uintptr_t>(rows) |
                    reinterpret_cast<uintptr_t>(deltas)) & 15) == 0 &&
                  ((reinterpret_cast<uintptr_t>(elig_required) |
                    reinterpret_cast<uintptr_t>(out)) & 3) == 0;
  verify_plan_fit_kernel<<<(threads + width - 1) / width, width, 0, stream>>>(
      used, totals, eligible, rows, deltas, elig_required, out, k, n, vec);
  return (int)cudaGetLastError();
}
