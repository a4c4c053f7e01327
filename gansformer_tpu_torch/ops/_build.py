"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and the objects link into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, from the package's own sources only, into
``gansformer_tpu_torch/_build/<hash>/`` where the hash covers the sources
and the flags, so an edited source rebuilds and an unchanged one loads
in milliseconds.  Nothing here runs at import time: the CPU tests import
every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
LIB_NAME = "libgansformer_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: ptxas reports each kernel's registers, spills and shared
# memory; the log is kept in ``build_info["log"]``.
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# What the last build did, for the smoke script's report.
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "gt_upfirdn": (_I, [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P, _I, _F, _F, _P]),
    "gt_modconv": (_I, [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _P, _P, _I, _F, _F, _P]),
    "gt_grid_to_latent": (_I, [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _F, _P]),
    "gt_latent_to_grid": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _F, _P]),
    "gt_grid_to_latent_bwd": (_I, [_I] + [_P] * 10 + [_I] * 5 + [_F, _P]),
    "gt_latent_to_grid_bwd": (_I, [_I] + [_P] * 10 + [_I] * 5 + [_F, _P]),
    "gt_modconv_dx": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _P, _P, _P]),
    "gt_modconv_dx_tile": (_I, []),
    "gt_modconv_dw": (_I, [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _P, _P, _I, _I, _I, _P]),
    "gt_attn_chunk": (_I, []),
    "gt_g2l_smem": (ctypes.c_longlong, [_I, _I, _I]),
    "gt_l2g_smem": (ctypes.c_longlong, [_I, _I]),
    "gt_attn_bwd_rows": (_I, []),
    "gt_g2l_bwd_smem": (ctypes.c_longlong, [_I, _I, _I]),
    "gt_l2g_bwd_smem": (ctypes.c_longlong, [_I, _I, _I]),
}


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _headers() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + ["/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build on a machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for path in sources() + _headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile (if needed) and return the path of the shared library."""
    out_dir = os.path.join(BUILD_ROOT, _digest())
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        build_info.update(path=lib_path, built=False, seconds=0.0)
        return lib_path
    os.makedirs(BUILD_ROOT, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-")
    try:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", CSRC,
                   "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, objs, failed = [], [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {os.path.basename(src)}\n{out}")
            objs.append(obj)
            if p.returncode != 0:
                failed.append(os.path.basename(src))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n"
                               + "\n".join(logs))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
                               *objs], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.makedirs(out_dir, exist_ok=True)
        os.replace(tmp_lib, lib_path)
        build_info.update(path=lib_path, built=True,
                          seconds=time.perf_counter() - t0,
                          log="\n".join(logs))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as an address."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(t) -> int:
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[name]
