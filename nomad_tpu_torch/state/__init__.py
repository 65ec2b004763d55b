"""Cluster state: host object store + card-resident node matrix."""

from .matrix import (  # noqa: F401
    ATTR_SLOTS,
    DEVICE_SLOTS,
    PRIORITY_BUCKETS,
    DeviceArrays,
    NodeMatrix,
    node_attributes,
    numeric_value,
    priority_bucket,
    stable_hash,
)
