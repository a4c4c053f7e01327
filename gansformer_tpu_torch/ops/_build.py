"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and the objects link into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, from the package's own sources only, into
``<build root>/<hash>/`` (the root is ``gansformer_tpu_torch/_build/``
unless a caller names another) where the hash covers the sources, the
flags and ``nvcc --version``, so an edited source or a new toolkit
rebuilds and an unchanged one loads in milliseconds.  ``signature()`` is
what a built library is valid for, which the serving warm start records
beside it (``serve/warmstart.py``).  Nothing here runs at import time:
the CPU tests import every module on a machine with no ``nvcc``.
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
LOG_NAME = "build.log"       # nvcc's output, ptxas report included
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas -v: ptxas reports each kernel's registers, spills and shared
# memory; the log is kept in ``build_info["log"]`` and beside the
# library, so a later process that loads the built library reads it too.
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_lock = threading.RLock()
_lib: Optional[ctypes.CDLL] = None
# What the last build did, for the smoke script's report.
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "gt_upfirdn": (_I, [_I, _I, _P, _P, _P] + [_I] * 12
                   + [_P, _I, _I, _F, _F, _P]),
    "gt_ufd_plan": (None, [_I] * 6 + [_P]),
    "gt_modconv": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _P, _P, _I, _I, _F, _F, _P]),
    "gt_modconv_fwd_tile": (_I, [_I]),
    "gt_modconv_fwd_smem": (_I, [_I, _I]),
    "gt_grid_to_latent": (_I, [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _F, _P]),
    "gt_g2l_plan": (None, [_I] * 6 + [_P]),
    "gt_latent_to_grid": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _I, _I, _I, _I, _F, _P]),
    "gt_l2g_plan": (None, [_I] * 6 + [_P]),
    "gt_grid_to_latent_bwd": (_I, [_I, _I] + [_P] * 9 + [_I] * 5
                              + [_F, _P]),
    "gt_g2l_bwd_plan": (None, [_I] * 6 + [_P]),
    "gt_latent_to_grid_bwd": (_I, [_I, _I] + [_P] * 10 + [_I] * 5
                              + [_F, _P]),
    "gt_l2g_bwd_plan": (None, [_I] * 6 + [_P]),
    "gt_modconv_dx": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _I, _I, _I, _I, _P, _P, _P]),
    "gt_modconv_dx_tile": (_I, [_I]),
    "gt_modconv_bwd_smem": (_I, [_I, _I, _I, _I, _I]),
    "gt_modconv_dw": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _P, _P, _I, _I, _I, _P]),
    "gt_attn_chunk": (_I, []),
    "gt_attn_bwd_rows": (_I, []),
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


_nvcc_version: Optional[str] = None


def nvcc_version() -> str:
    """``nvcc --version`` as it prints it (read once a process)."""
    global _nvcc_version
    if _nvcc_version is None:
        _nvcc_version = subprocess.run(
            [nvcc_path(), "--version"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    return _nvcc_version


def _digest() -> str:
    h = hashlib.sha256()
    for path in sources() + _headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    return h.hexdigest()[:16]


def library_path(build_root: Optional[str] = None) -> str:
    """Where ``build(build_root)`` puts the library of these sources."""
    return os.path.join(build_root or BUILD_ROOT, _digest(), LIB_NAME)


def signature() -> dict:
    """What a built library is valid for: the sources' digest (flags and
    toolkit included), the toolkit, the flags, torch, and the card."""
    import torch

    return {"sources": _digest(), "nvcc": nvcc_version(),
            "arch_flags": list(ARCH_FLAGS), "nvcc_flags": list(NVCC_FLAGS),
            "torch": torch.__version__,
            "device": torch.cuda.get_device_name(0),
            "capability": list(torch.cuda.get_device_capability(0))}


def build(build_root: Optional[str] = None) -> str:
    """Compile (if needed) into ``build_root`` and return the path of the
    shared library."""
    build_root = build_root or BUILD_ROOT
    lib_path = library_path(build_root)
    out_dir = os.path.dirname(lib_path)
    log_path = os.path.join(out_dir, LOG_NAME)
    if os.path.exists(lib_path):
        build_info.update(path=lib_path, built=False, seconds=0.0)
        if os.path.exists(log_path):          # the build's ptxas report
            with open(log_path) as f:
                build_info["log"] = f.read()
        return lib_path
    os.makedirs(build_root, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(dir=build_root, prefix="tmp-")
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
        with open(os.path.join(tmp, LOG_NAME), "w") as f:
            f.write("\n".join(logs))
        os.replace(os.path.join(tmp, LOG_NAME), log_path)
        os.replace(tmp_lib, lib_path)
        build_info.update(path=lib_path, built=True,
                          seconds=time.perf_counter() - t0,
                          log="\n".join(logs))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def loaded() -> bool:
    """Whether this process has loaded the library."""
    return _lib is not None


def load_path(path: str) -> ctypes.CDLL:
    """Load the library at ``path`` and bind its functions, unless this
    process has loaded it already (then that one is returned)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(path)
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
        return _lib


def load_library(build_root: Optional[str] = None) -> ctypes.CDLL:
    """The kernels' shared library, built on first use into
    ``build_root`` (default ``gansformer_tpu_torch/_build/``)."""
    with _lock:
        return _lib if _lib is not None else load_path(build(build_root))


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block may use


def check_smem(nbytes: int, what: str) -> None:
    """Raise where a launch would need more shared memory than a block may
    opt in to (the launch would be refused)."""
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{what} needs {nbytes} bytes of shared memory, "
                         f"more than the {SMEM_LIMIT} a block may use")


def stream_ptr(t) -> int:
    """The current CUDA stream of ``t``'s device, as an address (the raw
    handle, without building a ``torch.cuda.Stream``)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(t):
    """The context every wrapper launches in: ``t``'s device made current.
    A launcher runs on the calling thread's current device (its opt-ins,
    its launches), while ``stream_ptr(t)`` is a stream of ``t``'s device,
    so a tensor on another card than the current one would otherwise be
    launched on, or refused by, the wrong card."""
    import torch

    return torch.cuda.device(t.device)


DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(t) -> int:
    name = str(t.dtype)[6:]                 # "torch.bfloat16" -> "bfloat16"
    if name not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[name]
