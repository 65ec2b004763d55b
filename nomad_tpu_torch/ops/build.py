"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``; the sources build in parallel,
one ``nvcc`` each.  Libraries go to ``build/kernels/`` at the repository
root under a name that hashes the sources and flags, so an edited source
rebuilds and an unchanged one is reused within a checkout.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false``; no
``--use_fast_math``.  Fast math would change ``exp2f``, ``expf`` and
division, and a fused multiply-add rounds once where the plain PyTorch
version rounds twice — parity with the plain version rests on both.

Nothing here runs at import: the first kernel call builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("fused_place", "allocs_fit_verify", "system_feasible",
           "score_batch", "verify_plan_fit", "sharded_place")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

BUILD_DIR = CSRC.parents[2] / "build" / "kernels"

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# What nvcc/ptxas reported for each kernel at its last build.
ptxas_report: Dict[str, str] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or
    ``nvcc`` on the PATH.  Raises when there is none."""
    cands: List[str] = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name)}.so"


def build_all() -> float:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all started together.  Returns the wall seconds taken."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [k for k in KERNELS if not _lib_path(k).exists()]
    t0 = time.perf_counter()
    if todo:
        nvcc = find_nvcc()
        procs = {}
        for name in todo:
            tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        errors = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            ptxas_report[name] = log
            if proc.returncode != 0:
                errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, _lib_path(name))
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_ARGTYPES = {
    "nomad_fused_place": [_PTR] * 24 + [_INT] * 12 + [_PTR],
    "nomad_allocs_fit_verify": [_PTR] * 10 + [_INT] * 6 + [_PTR],
    "nomad_system_feasible": [_PTR] * 7 + [_INT] * 4 + [_PTR],
    "nomad_score_batch": [_PTR] * 21 + [_INT] * 10 + [_PTR],
    "nomad_verify_plan_fit": [_PTR] * 5 + [_INT] * 2 + [_PTR],
    "nomad_sharded_place": [_PTR, _INT, _PTR] + [_INT] * 10 + [_PTR],
    "nomad_sharded_usage": [_PTR] * 4 + [_INT] * 5 + [_PTR],
    # Launch-shape queries of the kernels that pick their own shape.
    "nomad_fused_place_shape": [_INT] * 9 + [_PTR],
    "nomad_score_batch_shape": [_INT] * 7 + [_PTR],
    "nomad_allocs_fit_verify_shape": [_INT] * 4 + [_PTR],
    "nomad_sharded_place_shape": [_INT] * 9 + [_PTR],
    "nomad_sharded_pair_bytes": [],
}
_ENTRY = {
    "fused_place": ("nomad_fused_place", "nomad_fused_place_shape"),
    "allocs_fit_verify": ("nomad_allocs_fit_verify",
                          "nomad_allocs_fit_verify_shape"),
    "system_feasible": ("nomad_system_feasible",),
    "score_batch": ("nomad_score_batch", "nomad_score_batch_shape"),
    "verify_plan_fit": ("nomad_verify_plan_fit",),
    "sharded_place": ("nomad_sharded_place", "nomad_sharded_place_shape",
                      "nomad_sharded_pair_bytes", "nomad_sharded_usage"),
}


def _expected_layout() -> List[int]:
    from ..state.matrix import DEVICE_SLOTS, DYN_PORT_CAPACITY, PRIORITY_BUCKETS
    from . import kernels as k
    from .encode import (
        MAX_AFFINITIES, MAX_CONSTRAINTS, MAX_DATACENTERS, MAX_SPREAD_VALUES,
        MAX_SPREADS, MAX_STATIC_PORTS,
    )

    out = [k.REQ_INT_OFF[f][0] for f, _ in k.REQ_INT_FIELDS]
    out.append(k.REQ_INT_WIDTH)
    out += [k.REQ_FLOAT_OFF[f][0] for f, _ in k.REQ_FLOAT_FIELDS]
    out.append(k.REQ_FLOAT_WIDTH)
    out += [MAX_CONSTRAINTS, MAX_AFFINITIES, MAX_DATACENTERS, MAX_SPREADS,
            MAX_SPREAD_VALUES, MAX_STATIC_PORTS, DEVICE_SLOTS,
            PRIORITY_BUCKETS, DYN_PORT_CAPACITY, k.PACKED_WIDTH,
            k.FUSED_PACKED_WIDTH, k.MAX_LANE_DELTAS]
    return out


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_lib_path(name)))
    # Prototypes once, at load: a call then passes Python ints as they are.
    for entry in _ENTRY[name]:
        fn = getattr(lib, entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    lib.nomad_req_layout.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.nomad_req_layout.restype = ctypes.c_int
    want = _expected_layout()
    buf = (ctypes.c_int * 64)()
    got_n = lib.nomad_req_layout(buf, 64)
    got = list(buf[:got_n])
    if got != want:
        raise RuntimeError(
            f"{name}: csrc/layout.cuh disagrees with ops/kernels.py "
            f"(library {got}, python {want})"
        )
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building every missing
    kernel first."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build_all()
            for k in KERNELS:
                if k not in _libs:
                    _libs[k] = _load(k)
        return _libs[name]
