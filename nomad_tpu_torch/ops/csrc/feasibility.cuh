// Per-node feasibility of system_feasible.cu, and the predicate test that
// scoring.cuh shares with it.
//
// The node-side half of nomad_tpu/ops/kernels.py:feasibility_mask
// (:265): eligibility, datacenter membership, the constraint predicates
// (_check_predicate, :141), the device check (device_mask, :234), the
// static- and dynamic-port check (port_mask, :242), the class-eligibility
// gather and the host mask.  Everything here is a boolean over integer
// and float compares, so the kernels that include it agree bit for bit
// with the plain PyTorch version (ops/kernels.py:feasibility_mask).
#pragma once

#include <stdint.h>

#include "layout.cuh"

// Op codes (ops/encode.py).
#define OP_EQ 0
#define OP_NEQ 1
#define OP_LT 2
#define OP_LTE 3
#define OP_GT 4
#define OP_GTE 5
#define OP_IS_SET 6
#define OP_IS_NOT_SET 7
#define OP_VER_EQ 8
#define OP_VER_LT 9
#define OP_VER_LTE 10
#define OP_VER_GT 11
#define OP_VER_GTE 12

// The matrix columns feasibility reads (N rows each).
struct NodeTables {
  const uint8_t* eligible;   // (N,)
  const int32_t* attr_hash;  // (N, A)
  const float* attr_num;     // (N, A)
  const float* attr_ver;     // (N, A)
  const int32_t* class_id;   // (N,)
  const int32_t* dev_total;  // (N, DEV_SLOTS)
  const int32_t* dev_used;   // (N, DEV_SLOTS)
  const int32_t* port_words; // (N, W) int32 view of the u32 bitmap
  const int32_t* dyn_used;   // (N,)
  int a;                     // attribute slots
  int w;                     // port words per node
};

// An op decoded once (pred_flags) for the per-node test (pred_holds).
#define PF_NUM 1    // compares the numeric or version value
#define PF_VER 2    // the version value, not the numeric one
#define PF_PRES 4   // is_set / is_not_set
#define PF_NEG 8    // != and is_not_set invert the result
#define PF_LT 16
#define PF_GT 32
#define PF_EQ 64

__host__ __device__ __forceinline__ int pred_flags(int op) {
  const bool is_ver = op >= OP_VER_EQ;
  const bool is_num = (op >= OP_LT && op <= OP_GTE) || is_ver;
  const bool is_pres = op == OP_IS_SET || op == OP_IS_NOT_SET;
  const bool negate = op == OP_NEQ || op == OP_IS_NOT_SET;
  const bool want_lt = op == OP_LT || op == OP_LTE || op == OP_VER_LT ||
                       op == OP_VER_LTE;
  const bool want_gt = op == OP_GT || op == OP_GTE || op == OP_VER_GT ||
                       op == OP_VER_GTE;
  const bool want_eq = op == OP_LTE || op == OP_GTE || op == OP_VER_EQ ||
                       op == OP_VER_LTE || op == OP_VER_GTE;
  return (is_num ? PF_NUM : 0) | (is_ver ? PF_VER : 0) |
         (is_pres ? PF_PRES : 0) | (negate ? PF_NEG : 0) |
         (want_lt ? PF_LT : 0) | (want_gt ? PF_GT : 0) | (want_eq ? PF_EQ : 0);
}

// One active predicate on a node's attribute hash `h` and value `v` (the
// numeric or version value; read only where PF_NUM is set).  Missing
// attributes fail `=` and the ordered compares and pass `!=`; NaN fails
// every ordered compare.
__device__ __forceinline__ bool pred_holds(int h, float v, int f,
                                           int want_hash, float want_num) {
  const bool present = h != 0;
  const bool cmp = ((f & PF_LT) && v < want_num) ||
                   ((f & PF_GT) && v > want_num) ||
                   ((f & PF_EQ) && v == want_num);
  const bool inner = (f & PF_NUM) ? cmp : ((f & PF_PRES) || h == want_hash);
  return (present && inner) != ((f & PF_NEG) != 0);
}

// One predicate against one node (kernels.py:_check_predicate).  Inactive
// slots (slot < 0) pass.
__device__ __forceinline__ bool check_predicate(const NodeTables& M, int row,
                                                int slot, int op, int want_hash,
                                                float want_num) {
  if (slot < 0) return true;
  if (slot >= M.a) slot = M.a - 1;  // gathers clamp, as in JAX
  const int f = pred_flags(op);
  const int h = M.attr_hash[(size_t)row * M.a + slot];
  const float v = !(f & PF_NUM) ? 0.0f
                  : (f & PF_VER) ? M.attr_ver[(size_t)row * M.a + slot]
                                 : M.attr_num[(size_t)row * M.a + slot];
  return pred_holds(h, v, f, want_hash, want_num);
}

// Node i passes eligibility, datacenter, the first c_width constraint
// slots, devices, ports (when `ports`), class eligibility and the host
// mask.  `ri`/`rf` are one lane's packed request; `class_elig` has k
// entries, and a class id past its end reads the last one, as JAX's
// out-of-bounds gather does.  `elig` returns the node's eligible bit (the
// filtered count needs it apart from the rest).
__device__ __forceinline__ bool node_feasible(const NodeTables& M, int i,
                                              const int* ri, const float* rf,
                                              int c_width, bool ports,
                                              const uint8_t* class_elig, int k,
                                              const uint8_t* host_mask,
                                              bool& elig) {
  elig = M.eligible[i] != 0;
  bool feas = elig;
  if (feas && ri[RI_DC_HASH] != -1) {  // -1: the host filters datacenters
    const int dc = M.attr_hash[(size_t)i * M.a];  // slot 0: node.datacenter
    bool member = false;
    for (int j = 0; j < MAX_DC; ++j) {
      const int want = ri[RI_DC_HASH + j];
      member |= (dc == want) && (want > 0);
    }
    feas = member;
  }
  for (int c = 0; feas && c < c_width; ++c)
    feas = check_predicate(M, i, ri[RI_C_SLOT + c], ri[RI_C_OP + c],
                           ri[RI_C_HASH + c], rf[RF_C_NUM + c]);
  for (int j = 0; feas && j < DEV_SLOTS; ++j) {
    const int want = ri[RI_DEV_ASK + j];
    const int free_ = M.dev_total[(size_t)i * DEV_SLOTS + j] -
                      M.dev_used[(size_t)i * DEV_SLOTS + j];
    feas = (free_ >= want) || (want == 0);
  }
  if (feas && ports) {
    for (int j = 0; feas && j < MAX_PORTS; ++j) {
      const int port = ri[RI_P_STATIC + j];
      if (port < 0) continue;
      // Shift the u32 bits, never the signed int32 view.
      const unsigned word =
          (unsigned)M.port_words[(size_t)i * M.w + (port >> 5)];
      feas = ((word >> (port & 31)) & 1u) == 0u;
    }
    feas = feas && (M.dyn_used[i] + ri[RI_P_DYN] <= DYN_PORT_CAPACITY);
  }
  if (feas) {
    int cid = M.class_id[i];
    if (cid < 0) {
      feas = false;
    } else {
      if (cid >= k) cid = k - 1;
      feas = class_elig[cid] != 0;
    }
  }
  return feas && host_mask[i] != 0;
}
