// Shared layout of the kernels' inputs: encoding widths and the packed
// request's field offsets.  These mirror nomad_tpu_torch/ops/kernels.py
// (REQ_INT_FIELDS / REQ_FLOAT_FIELDS) and ops/encode.py; every library
// exports nomad_req_layout() and the Python loader refuses a library whose
// table differs from the Python one.
#pragma once

#define MAX_C 16       // constraints
#define MAX_A 8        // affinities
#define MAX_DC 8       // datacenters
#define MAX_S 2        // spread stanzas
#define MAX_V 16       // values per spread stanza
#define MAX_PORTS 8    // static ports per request
#define DEV_SLOTS 8    // device-type slots
#define PRIO_BUCKETS 16
#define DYN_PORT_CAPACITY 12001
#define MAX_LANE_DELTAS 1024  // in-flight delta rows of a fused_place lane

// int32 request fields (offset, width)
#define RI_C_SLOT 0
#define RI_C_OP 16
#define RI_C_HASH 32
#define RI_DC_HASH 48
#define RI_DEV_ASK 56
#define RI_ALGORITHM 64
#define RI_A_SLOT 65
#define RI_A_OP 73
#define RI_A_HASH 81
#define RI_S_SLOT 89
#define RI_S_EVEN 91
#define RI_S_VALUE_HASH 93
#define RI_PREEMPT_BUCKET 125
#define RI_DISTINCT_HOSTS 126
#define RI_P_STATIC 127
#define RI_P_DYN 135
#define REQ_INT_WIDTH 136

// float32 request fields
#define RF_ASK 0
#define RF_C_NUM 3
#define RF_DESIRED_COUNT 19
#define RF_A_NUM 20
#define RF_A_WEIGHT 28
#define RF_S_WEIGHT 36
#define RF_S_DESIRED 38
#define RF_S_IMPLICIT 70
#define RF_S_SUM_WEIGHTS 72
#define REQ_FLOAT_WIDTH 73

// Output columns (kernels.PACKED_* / FUSED_PACKED_*).
#define PACKED_WIDTH 7
#define FUSED_PACKED_WIDTH 8

static const int kNomadLayout[] = {
    // int fields in packing order, then the int width
    RI_C_SLOT, RI_C_OP, RI_C_HASH, RI_DC_HASH, RI_DEV_ASK, RI_ALGORITHM,
    RI_A_SLOT, RI_A_OP, RI_A_HASH, RI_S_SLOT, RI_S_EVEN, RI_S_VALUE_HASH,
    RI_PREEMPT_BUCKET, RI_DISTINCT_HOSTS, RI_P_STATIC, RI_P_DYN,
    REQ_INT_WIDTH,
    // float fields in packing order, then the float width
    RF_ASK, RF_C_NUM, RF_DESIRED_COUNT, RF_A_NUM, RF_A_WEIGHT, RF_S_WEIGHT,
    RF_S_DESIRED, RF_S_IMPLICIT, RF_S_SUM_WEIGHTS, REQ_FLOAT_WIDTH,
    // widths
    MAX_C, MAX_A, MAX_DC, MAX_S, MAX_V, MAX_PORTS, DEV_SLOTS, PRIO_BUCKETS,
    DYN_PORT_CAPACITY, PACKED_WIDTH, FUSED_PACKED_WIDTH, MAX_LANE_DELTAS,
};

// Copies the layout table into out[0..cap) and returns its length.
extern "C" int nomad_req_layout(int* out, int cap) {
  const int n = (int)(sizeof(kNomadLayout) / sizeof(kNomadLayout[0]));
  for (int i = 0; i < n && i < cap; ++i) out[i] = kNomadLayout[i];
  return n;
}
