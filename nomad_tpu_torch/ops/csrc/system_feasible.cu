// system_feasible — feasibility and fit of one request on every node.
//
// Replaces nomad_tpu/ops/kernels.py:system_feasible (:289), the system
// scheduler's one device program (SystemStack.feasible_nodes,
// nomad_tpu/scheduler/stack.py:845): feasibility_mask at full features
// (all 16 constraint slots, ports on) and the fit half of
// fit_and_binpack, stacked as one (2, N) bool so the host pays a single
// device-to-host copy.
//
// Design: small CTAs of SF_TILE nodes, one node a thread, so N=10240 is
// 160 CTAs and every SM of an H100 takes part; each warp works on its 32
// rows alone, with no block-wide barrier.  A warp runs two memory round
// trips:
//   1. each lane's loads of its node's own columns (eligible, host mask,
//      class id, dyn_used, totals, base usage), which do not depend on the
//      request, beside the warp's copy of the packed request into shared
//      memory (every load issued before the first store);
//   2. after the lanes decode the request — the attribute quads (four
//      slots, 16 bytes of a row) its datacenter slot and constraint slots
//      name in attr_hash, and those its numeric and version constraints
//      name in attr_num/attr_ver, lanes naming the same quad sharing its
//      tile entry — the warp loads exactly those quads of its 32 rows into
//      shared memory with 16-byte vector loads (neighbouring lanes on
//      neighbouring quads and rows), beside each lane's device-slot,
//      port-word and class-eligibility loads.  No lane reads the attribute
//      tables at a 4·A stride one slot at a time.
// Each lane then evaluates its node (the semantics of
// feasibility.cuh:node_feasible, every term from shared memory or
// registers, the active constraints only) and the fit used0 + ask <=
// totals on all three dimensions; the warp writes both output rows as
// whole 4-byte words (bytes only at a ragged or unaligned edge), each
// byte exactly 0 or 1 as torch.bool wants.  Padded constraint slots
// (slot < 0) pass.
//
// What bounds it on an H100: the bytes.  The function reads each matrix
// column the request refers to once (about 50 bytes a node for a plain
// request: eligible, class id, host mask, the datacenter hash, dyn_used, a
// port word, totals, used0) and writes 2 bytes a node, about 0.5 MB at
// N=10240 — a fraction of a microsecond at 3.35 TB/s, so a launch of a
// few microseconds is launch latency and two dependent memory round trips
// (the request, then the request-dependent columns).
//
// Numerics: the fit is one float32 add and one compare per dimension
// (built with -fmad=false, nothing to fuse), so it is bit-identical to
// the plain PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "feasibility.cuh"
#include "layout.cuh"

#ifndef SF_TILE
#define SF_TILE 64  // nodes a CTA, one a thread
#endif
#define SF_WARPS (SF_TILE / 32)
#define SF_SLOTS (MAX_C + 1)  // the constraint slots, then the datacenter slot
#define SF_UNROLL 4  // tile entries a lane loads before it stores them

// Column order of the host pointer array (ops/kernels.py: the fields of
// DeviceArrays, in order).
enum {
  COL_TOTALS, COL_USED, COL_ELIGIBLE, COL_ATTR_HASH, COL_ATTR_NUM,
  COL_ATTR_VER, COL_CLASS_ID, COL_DEV_TOTAL, COL_DEV_USED, COL_PRIO_USED,
  COL_PORT_WORDS, COL_DYN_USED, N_COLS
};

// Quad `quad` (slots 4·quad .. 4·quad+3) of row `row` of an (N, a) table;
// slots past `a` read 0 where the row is not a whole number of quads.
__device__ __forceinline__ int4 load_quad(const int32_t* base, int row,
                                          int quad, int a, bool vec) {
  const int32_t* p = base + (size_t)row * a + quad * 4;
  if (vec) return __ldg(reinterpret_cast<const int4*>(p));
  const int s = quad * 4;
  return make_int4(p[0], s + 1 < a ? p[1] : 0, s + 2 < a ? p[2] : 0,
                   s + 3 < a ? p[3] : 0);
}

__device__ __forceinline__ int tile_word(const int4& q, int word) {
  return reinterpret_cast<const int*>(&q)[word];
}

// Bytes src[0..cnt) to dst by one warp: whole aligned words, single
// bytes only at the unaligned head and the tail (cnt <= 32).
__device__ __forceinline__ void warp_store_bytes(uint8_t* dst,
                                                 const uint8_t* src, int cnt,
                                                 int ln) {
  const int head = min(cnt, (int)((4u - ((uintptr_t)dst & 3u)) & 3u));
  const int words = (cnt - head) >> 2;
  const int tail = cnt - head - (words << 2);
  if (ln < head) {
    dst[ln] = src[ln];
  } else if (ln < head + words) {
    const int b = head + ((ln - head) << 2);
    reinterpret_cast<uint32_t*>(dst + head)[ln - head] =
        (uint32_t)src[b] | ((uint32_t)src[b + 1] << 8) |
        ((uint32_t)src[b + 2] << 16) | ((uint32_t)src[b + 3] << 24);
  } else if (ln < head + words + tail) {
    const int b = head + (words << 2) + (ln - head - words);
    dst[b] = src[b];
  }
}

__global__ void __launch_bounds__(SF_TILE)
system_feasible_kernel(NodeTables M, const float* __restrict__ totals,
                       const float* __restrict__ used0,
                       const int32_t* __restrict__ req_i,
                       const float* __restrict__ req_f,
                       const uint8_t* __restrict__ class_elig, int k,
                       const uint8_t* __restrict__ host_mask,
                       uint8_t* __restrict__ out, int n, bool vec) {
  // Per warp: the packed request, the tiles' attribute quad ids (in the
  // value tile with bit 30 set for attr_ver), the quads of its rows, the
  // result bytes.
  __shared__ int ri_w[SF_WARPS][REQ_INT_WIDTH];
  __shared__ float rf_w[SF_WARPS][REQ_FLOAT_WIDTH];
  __shared__ int quads_h[SF_WARPS][SF_SLOTS], quads_v[SF_WARPS][MAX_C];
  __shared__ int4 tile_h[SF_SLOTS][SF_TILE];
  __shared__ int4 tile_v[MAX_C][SF_TILE];
  __shared__ uint8_t res[2][SF_TILE];

  const int tid = threadIdx.x, wid = tid >> 5, ln = tid & 31;
  const int i0 = blockIdx.x * SF_TILE + wid * 32;  // the warp's first row
  const int rows = min(32, n - i0);
  if (rows <= 0) return;
  const int i = i0 + ln;
  const bool own = ln < rows;
  int* ri = ri_w[wid];
  float* rf = rf_w[wid];

  // Round 1: the node's own columns, and the request.
  int elig = 0, hm = 0, cid = -1, dyn = 0;
  float t0 = 0.f, t1 = 0.f, t2 = 0.f, u0 = 0.f, u1 = 0.f, u2 = 0.f;
  if (own) {
    elig = M.eligible[i];
    hm = host_mask[i];
    cid = M.class_id[i];
    dyn = M.dyn_used[i];
    t0 = totals[(size_t)i * 3];
    t1 = totals[(size_t)i * 3 + 1];
    t2 = totals[(size_t)i * 3 + 2];
    u0 = used0[(size_t)i * 3];
    u1 = used0[(size_t)i * 3 + 1];
    u2 = used0[(size_t)i * 3 + 2];
  }
  {
    constexpr int kI = (REQ_INT_WIDTH + 31) / 32;
    constexpr int kF = (REQ_FLOAT_WIDTH + 31) / 32;
    int vi[kI];
    float vf[kF];
#pragma unroll
    for (int u = 0; u < kI; ++u)
      vi[u] = ln + 32 * u < REQ_INT_WIDTH ? req_i[ln + 32 * u] : 0;
#pragma unroll
    for (int u = 0; u < kF; ++u)
      vf[u] = ln + 32 * u < REQ_FLOAT_WIDTH ? req_f[ln + 32 * u] : 0.0f;
#pragma unroll
    for (int u = 0; u < kI; ++u)
      if (ln + 32 * u < REQ_INT_WIDTH) ri[ln + 32 * u] = vi[u];
#pragma unroll
    for (int u = 0; u < kF; ++u)
      if (ln + 32 * u < REQ_FLOAT_WIDTH) rf[ln + 32 * u] = vf[u];
  }
  __syncwarp();

  // Round 2: the node's request-dependent columns (asked device slots, the
  // words of the static ports, the class's eligibility), issued before the
  // decode; then the named quads of the warp's rows.
  int dev_free[DEV_SLOTS];
  unsigned port_word[MAX_PORTS];
#pragma unroll
  for (int j = 0; j < DEV_SLOTS; ++j) {
    dev_free[j] = 0;
    if (own && ri[RI_DEV_ASK + j] != 0)
      dev_free[j] = M.dev_total[(size_t)i * DEV_SLOTS + j] -
                    M.dev_used[(size_t)i * DEV_SLOTS + j];
  }
#pragma unroll
  for (int j = 0; j < MAX_PORTS; ++j) {
    const int port = ri[RI_P_STATIC + j];
    port_word[j] = 0u;
    // Shift the u32 bits, never the signed int32 view.
    if (own && port >= 0)
      port_word[j] = (unsigned)M.port_words[(size_t)i * M.w + (port >> 5)];
  }
  const int ce = (own && cid >= 0) ? class_elig[min(cid, k - 1)] : 0;

  // Decode: lanes 0-15 the constraints, lane 16 the datacenter (slot 0).
  const unsigned lt = (1u << ln) - 1u;
  bool act = false;
  int slot = 0, f = 0;
  if (ln < MAX_C) {
    slot = ri[RI_C_SLOT + ln];
    act = slot >= 0;
    f = pred_flags(ri[RI_C_OP + ln]);
  } else if (ln == MAX_C) {
    act = ri[RI_DC_HASH] != -1;  // -1: the host filters datacenters
  }
  if (slot >= M.a) slot = M.a - 1;  // gathers clamp, as in JAX
  const int quad = act ? slot >> 2 : -1;
  const int lead_h = __ffs(__match_any_sync(0xffffffffu, quad)) - 1;
  const unsigned leaders_h = __ballot_sync(0xffffffffu, act && ln == lead_h);
  if (act && ln == lead_h) quads_h[wid][__popc(leaders_h & lt)] = quad;
  const int my_h = act ? __popc(leaders_h & ((1u << lead_h) - 1u)) : -1;
  const bool need_v = act && ln < MAX_C && (f & PF_NUM);
  const int vkey = need_v ? (quad | ((f & PF_VER) ? 1 << 30 : 0)) : -1;
  const int lead_v = __ffs(__match_any_sync(0xffffffffu, vkey)) - 1;
  const unsigned leaders_v = __ballot_sync(0xffffffffu,
                                           need_v && ln == lead_v);
  if (need_v && ln == lead_v) quads_v[wid][__popc(leaders_v & lt)] = vkey;
  const int my_v = need_v ? __popc(leaders_v & ((1u << lead_v) - 1u)) : -1;
  const int nh = __popc(leaders_h), nv = __popc(leaders_v);
  __syncwarp();

  // Entries [0, rows·nh) of the hash tile, [rows·nh, rows·(nh+nv)) of the
  // value tile.
  const int col0 = wid * 32;  // the warp's columns of the tiles
  for (int e0 = ln; e0 < rows * (nh + nv); e0 += SF_UNROLL * 32) {
    int4 v[SF_UNROLL];
#pragma unroll
    for (int u = 0; u < SF_UNROLL; ++u) {
      const int e = e0 + u * 32;
      if (e < rows * nh) {
        const int node = e / nh;
        v[u] = load_quad(M.attr_hash, i0 + node, quads_h[wid][e - node * nh],
                         M.a, vec);
      } else if (e < rows * (nh + nv)) {
        const int node = (e - rows * nh) / nv;
        const int key = quads_v[wid][e - rows * nh - node * nv];
        const int32_t* base = reinterpret_cast<const int32_t*>(
            (key >> 30) ? M.attr_ver : M.attr_num);
        v[u] = load_quad(base, i0 + node, key & ((1 << 30) - 1), M.a, vec);
      }
    }
#pragma unroll
    for (int u = 0; u < SF_UNROLL; ++u) {
      const int e = e0 + u * 32;
      if (e < rows * nh) {
        const int node = e / nh;
        tile_h[e - node * nh][col0 + node] = v[u];
      } else if (e < rows * (nh + nv)) {
        const int node = (e - rows * nh) / nv;
        tile_v[e - rows * nh - node * nv][col0 + node] = v[u];
      }
    }
  }
  __syncwarp();

  // The node's verdicts (every lane runs the shuffles; only own lanes'
  // results are stored).
  bool feas = elig != 0;
  if (ri[RI_DC_HASH] != -1) {
    const int dc = tile_word(tile_h[__shfl_sync(0xffffffffu, my_h, MAX_C)][tid],
                             0);
    bool member = false;
#pragma unroll
    for (int j = 0; j < MAX_DC; ++j) {
      const int want = ri[RI_DC_HASH + j];
      member |= (dc == want) && (want > 0);
    }
    feas = feas && member;
  }
  for (unsigned am = __ballot_sync(0xffffffffu, act && ln < MAX_C); am;
       am &= am - 1) {
    const int c = __ffs(am) - 1;
    const int qh = __shfl_sync(0xffffffffu, my_h, c);
    const int word = __shfl_sync(0xffffffffu, slot & 3, c);
    const int fc = __shfl_sync(0xffffffffu, f, c);
    const int qv = __shfl_sync(0xffffffffu, my_v, c);
    const int h = tile_word(tile_h[qh][tid], word);
    const float v =
        (fc & PF_NUM) ? __int_as_float(tile_word(tile_v[qv][tid], word)) : 0.0f;
    feas = feas && pred_holds(h, v, fc, ri[RI_C_HASH + c], rf[RF_C_NUM + c]);
  }
#pragma unroll
  for (int j = 0; j < DEV_SLOTS; ++j) {
    const int want = ri[RI_DEV_ASK + j];
    feas = feas && ((dev_free[j] >= want) || (want == 0));
  }
#pragma unroll
  for (int j = 0; j < MAX_PORTS; ++j) {
    const int port = ri[RI_P_STATIC + j];
    feas = feas && (port < 0 || ((port_word[j] >> (port & 31)) & 1u) == 0u);
  }
  feas = feas && (dyn + ri[RI_P_DYN] <= DYN_PORT_CAPACITY);
  feas = feas && cid >= 0 && ce != 0 && hm != 0;
  const bool fits = u0 + rf[RF_ASK] <= t0 && u1 + rf[RF_ASK + 1] <= t1 &&
                    u2 + rf[RF_ASK + 2] <= t2;
  if (own) {
    res[0][tid] = feas ? 1 : 0;
    res[1][tid] = fits ? 1 : 0;
  }
  __syncwarp();
  warp_store_bytes(out + i0, &res[0][col0], rows, ln);
  warp_store_bytes(out + (size_t)n + i0, &res[1][col0], rows, ln);
}

// `cols` is a host array of the matrix's N_COLS column pointers (the
// DeviceArrays fields in order); `used0` replaces its usage column.
extern "C" int nomad_system_feasible(const void* const* cols,
                                     const float* used0, const int32_t* req_i,
                                     const float* req_f,
                                     const uint8_t* class_elig,
                                     const uint8_t* host_mask, uint8_t* out,
                                     int n, int a, int w, int k,
                                     cudaStream_t stream) {
  if (n <= 0 || a <= 0 || w <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  NodeTables M;
  M.eligible = static_cast<const uint8_t*>(cols[COL_ELIGIBLE]);
  M.attr_hash = static_cast<const int32_t*>(cols[COL_ATTR_HASH]);
  M.attr_num = static_cast<const float*>(cols[COL_ATTR_NUM]);
  M.attr_ver = static_cast<const float*>(cols[COL_ATTR_VER]);
  M.class_id = static_cast<const int32_t*>(cols[COL_CLASS_ID]);
  M.dev_total = static_cast<const int32_t*>(cols[COL_DEV_TOTAL]);
  M.dev_used = static_cast<const int32_t*>(cols[COL_DEV_USED]);
  M.port_words = static_cast<const int32_t*>(cols[COL_PORT_WORDS]);
  M.dyn_used = static_cast<const int32_t*>(cols[COL_DYN_USED]);
  M.a = a;
  M.w = w;
  // 16-byte quads when every attribute row starts on a 16-byte boundary.
  const bool vec = a % 4 == 0 &&
                   (((uintptr_t)M.attr_hash | (uintptr_t)M.attr_num |
                     (uintptr_t)M.attr_ver) & 15u) == 0;
  const int blocks = (n + SF_TILE - 1) / SF_TILE;
  system_feasible_kernel<<<blocks, SF_TILE, 0, stream>>>(
      M, static_cast<const float*>(cols[COL_TOTALS]), used0, req_i, req_f,
      class_elig, k, host_mask, out, n, vec);
  return (int)cudaGetLastError();
}
