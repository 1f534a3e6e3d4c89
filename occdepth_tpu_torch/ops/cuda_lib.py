"""Build and load the port's hand-written CUDA kernels.

All `csrc/*.cu` sources compile with nvcc into one shared library with a
plain C interface, loaded with ctypes: one nvcc per source, all started
together, then one link.  The sources share `csrc/hopper.cuh` (TMA tensor
maps, mbarriers, wgmma); the libcuda entry point that encodes tensor maps
is resolved at run time (dlsym), so the library links against the CUDA
runtime alone.  The build runs at the first CUDA use, never at
import, and is keyed by a hash of the sources, headers and flags: a fresh
checkout builds once into `build/kernels/` at the repo root (listed in
.gitignore) and later processes reuse the library.

Each C entry point takes raw device pointers, sizes, strides and the CUDA
stream, launches on that stream without synchronising, and returns
`cudaGetLastError()`; the Python wrappers raise on a non-zero return.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    "build", "kernels",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# argtypes per entry point: pointers and the stream as c_void_p (a bare
# Python int would be passed as a 32-bit C int and cut the pointer)
_SIGNATURES = {
    "occ_stereo_cosine_fuse": (
        [_P, _P, _P, _P, _P, _I64, _I64, ctypes.c_int, _I64, _I64, _I64,
         _I64, ctypes.c_float, _P]
    ),
    "occ_flosp_stereo_lift": (
        [_P, _P, ctypes.c_int, _P, _P, _P, ctypes.c_int, _I64, _I64,
         ctypes.c_int, ctypes.c_int, ctypes.c_float, _P]
    ),
    "occ_flosp_stereo_lift_backward": (
        [_P, _P, _P, ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, _I64, _I64,
         ctypes.c_int, ctypes.c_int, ctypes.c_float, _P]
    ),
    "occ_crp_relation_matmul": (
        [_P, _P, _P, ctypes.c_int, ctypes.c_int] + [_I64] * 16 + [_P]
    ),
    "occ_dw_filter_grad": (
        [_P, _P, _P, ctypes.c_int, ctypes.c_int] + [_I64] * 4
        + [ctypes.c_int] * 6 + [_P]
    ),
    "occ_conv3x3": [_P, _P, _P, _P, ctypes.c_int] + [_I64] * 5 + [_P],
    "occ_pack_nhwc": [_P, _P, ctypes.c_int] + [_I64] * 9 + [_P],
    "occ_row_gather": [_P, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P],
    "occ_matmul_probe": [_P, _P, _P] + [_I64] * 4 + [_P],
    "occ_hopper_selftest": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P],
    "occ_hopper_selftest_rs": [_P, _P, _P, _P],
    "occ_hopper_selftest_tf32": [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P],
    "occ_split_tf32": [_P, _P] + [_I64] * 7 + [_P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> tuple:
    """Compile the sources if no library with their hash exists yet.

    Returns (library path, seconds spent compiling: 0 when the library was
    already built).  nvcc's output, with ptxas's per-kernel register and
    shared-memory report, is kept beside the library as `<library>.log`.
    """
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    digest = _digest(sources + _headers())
    lib_path = os.path.join(BUILD_DIR, f"libocc_kernels-{digest}.so")
    if os.path.exists(lib_path):
        return lib_path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    log = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, os.path.basename(src) + ".o")
                for src in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outs = [proc.communicate()[0] for proc in procs]
        tmp = os.path.join(work, "lib.so")
        # -ldl: hopper.cuh resolves cuTensorMapEncodeTiled with dlsym
        link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp, *objs, "-ldl"]
        runs = list(zip(cmds, [proc.returncode for proc in procs], outs))
        if all(rc == 0 for _, rc, _ in runs):
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            runs.append((link, proc.returncode, proc.stdout))
        for cmd, rc, out in runs:
            log.append(f"$ {' '.join(cmd)}\n{out}")
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n" + log[-1])
        # atomic: a concurrent build never sees half a file
        os.replace(tmp, lib_path)
    seconds = time.perf_counter() - t0
    with open(lib_path + ".log", "w") as f:
        f.write("\n".join(log))
    return lib_path, seconds


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's argtypes set."""
    lib_path, _ = build()
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    # a size, not an error code
    fn = lib.occ_flosp_stereo_lift_backward_workspace
    fn.argtypes = [_I64, _I64, ctypes.c_int]
    fn.restype = _I64
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
