// system_feasible — feasibility and fit of one request on every node.
//
// Replaces nomad_tpu/ops/kernels.py:system_feasible (:289), the system
// scheduler's one device program (SystemStack.feasible_nodes,
// nomad_tpu/scheduler/stack.py:845): feasibility_mask at full features
// (all 16 constraint slots, ports on) and the fit half of
// fit_and_binpack, stacked as one (2, N) bool so the host pays a single
// device-to-host copy.
//
// Design: one thread per node row.  Each block first copies the packed
// request (csrc/layout.cuh, one lane) into shared memory; then every
// thread runs the shared per-node feasibility (feasibility.cuh, the same
// code fused_place runs) and the fit test used0 + ask <= totals on all
// three dimensions, and writes one byte of each output row: exactly 0 or
// 1, as torch.bool wants.  Padded constraint slots (slot < 0) pass.
//
// What bounds it on an H100: the bytes.  The function reads each matrix
// column the request refers to once (about 50 bytes a node for a plain
// request: eligible, class id, host mask, the datacenter hash, dyn_used, a
// port word, totals, used0) and writes 2 bytes a node, about 0.5 MB at
// N=10240 — a fraction of a microsecond at 3.35 TB/s, so a launch of a
// few microseconds is all launch latency.  Node rows are read by
// neighbouring threads at a stride of the row width (uncoalesced for the
// (N, A) attribute tables); a transposed layout is later work.
//
// Numerics: the fit is one float32 add and one compare per dimension
// (built with -fmad=false, nothing to fuse), so it is bit-identical to
// the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "feasibility.cuh"
#include "layout.cuh"

#define THREADS 256

__global__ void __launch_bounds__(THREADS)
system_feasible_kernel(NodeTables M, const float* __restrict__ totals,
                       const float* __restrict__ used0,
                       const int32_t* __restrict__ req_i,
                       const float* __restrict__ req_f,
                       const uint8_t* __restrict__ class_elig, int k,
                       const uint8_t* __restrict__ host_mask,
                       uint8_t* __restrict__ out, int n) {
  __shared__ int ri[REQ_INT_WIDTH];
  __shared__ float rf[REQ_FLOAT_WIDTH];
  for (int j = threadIdx.x; j < REQ_INT_WIDTH; j += THREADS) ri[j] = req_i[j];
  for (int j = threadIdx.x; j < REQ_FLOAT_WIDTH; j += THREADS) rf[j] = req_f[j];
  __syncthreads();

  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  bool elig;
  const bool mask = node_feasible(M, i, ri, rf, MAX_C, true, class_elig, k,
                                  host_mask, elig);
  const size_t r = (size_t)i * 3;
  const bool fits = used0[r] + rf[RF_ASK] <= totals[r] &&
                    used0[r + 1] + rf[RF_ASK + 1] <= totals[r + 1] &&
                    used0[r + 2] + rf[RF_ASK + 2] <= totals[r + 2];
  out[i] = mask ? 1 : 0;
  out[(size_t)n + i] = fits ? 1 : 0;
}

extern "C" int nomad_system_feasible(
    const float* totals, const float* used0, const uint8_t* eligible,
    const int32_t* attr_hash, const float* attr_num, const float* attr_ver,
    const int32_t* class_id, const int32_t* dev_total, const int32_t* dev_used,
    const int32_t* port_words, const int32_t* dyn_used, const int32_t* req_i,
    const float* req_f, const uint8_t* class_elig, const uint8_t* host_mask,
    uint8_t* out, int n, int a, int w, int k, cudaStream_t stream) {
  if (n <= 0 || a <= 0 || w <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  NodeTables M;
  M.eligible = eligible;
  M.attr_hash = attr_hash;
  M.attr_num = attr_num;
  M.attr_ver = attr_ver;
  M.class_id = class_id;
  M.dev_total = dev_total;
  M.dev_used = dev_used;
  M.port_words = port_words;
  M.dyn_used = dyn_used;
  M.a = a;
  M.w = w;
  const int blocks = (n + THREADS - 1) / THREADS;
  system_feasible_kernel<<<blocks, THREADS, 0, stream>>>(
      M, totals, used0, req_i, req_f, class_elig, k, host_mask, out, n);
  return (int)cudaGetLastError();
}
