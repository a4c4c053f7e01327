"""The port's native host ops: ``host_ops.cpp`` (CRC32C, the TFRecord
frame scan, the Example walk; a copy of the JAX package's) built with
``g++ -O3 -shared`` at first use into ``gansformer_tpu_torch/_build/``,
keyed by the source's hash, and loaded with ``ctypes``.  They serve the
host data path that feeds the card and replace no TPU kernel.

Without a C++ compiler, or with ``GANSFORMER_TPU_NO_NATIVE=1``,
``get_lib()`` is None and the callers take their pure-Python paths
(which skip the CRCs when reading).  ``build_info`` says what the last
build did, for ``chip_smoke.py``'s report.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "host_ops.cpp")
_CACHE = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_info: dict = {}


def _compile() -> Optional[str]:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(_CACHE, f"host_ops-{tag}.so")
    build_info.update(path=out, built=False, seconds=0.0)
    if os.path.exists(out):
        return out
    os.makedirs(_CACHE, exist_ok=True)
    # build to a temp name and rename into place (concurrent processes)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_CACHE)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, text=True, timeout=120)
        os.replace(tmp, out)
        build_info.update(built=True, seconds=time.perf_counter() - t0)
        return out
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        build_info.update(path=None, error=f"{type(e).__name__}: "
                          f"{getattr(e, 'stderr', '') or e}"[:500])
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled host-ops library, or None (callers use Python paths)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("GANSFORMER_TPU_NO_NATIVE") == "1":
        build_info.update(path=None, error="GANSFORMER_TPU_NO_NATIVE=1")
        return None
    path = _compile()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.gft_crc32c.restype = ctypes.c_uint32
    lib.gft_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.gft_scan_records.restype = ctypes.c_int64
    lib.gft_scan_records.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_size_t)]
    lib.gft_parse_example.restype = ctypes.c_int
    lib.gft_parse_example.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    _lib = lib
    return _lib


def crc32c(data: bytes) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    return int(lib.gft_crc32c(data, len(data)))


def scan_records(buf: bytes, verify_crc: bool = False):
    """(offsets, lengths, consumed) for every COMPLETE TFRecord payload in
    ``buf``, or None without the library.  ``consumed`` covers the
    complete records only, so a caller can stream a file in chunks.
    Raises ValueError on a CRC mismatch (``verify_crc``)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    cap = max(16, len(buf) // 16)          # record overhead is 16 bytes
    offs = np.empty(cap, np.int64)
    lens = np.empty(cap, np.int64)
    consumed = ctypes.c_size_t()
    err_pos = ctypes.c_size_t()
    n = lib.gft_scan_records(
        buf, len(buf),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cap, int(verify_crc), ctypes.byref(consumed), ctypes.byref(err_pos))
    if n < 0:
        raise ValueError(
            f"corrupt TFRecord: CRC mismatch at byte {err_pos.value}")
    return offs[:n], lens[:n], consumed.value


def parse_example(payload: bytes):
    """(shape tuple, data_offset, data_length) of one reference-schema
    Example, spans within ``payload``; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    shape = (ctypes.c_int64 * 4)()
    ndim = ctypes.c_int32()
    d_off = ctypes.c_int64()
    d_len = ctypes.c_int64()
    rc = lib.gft_parse_example(
        payload, len(payload), shape, ctypes.byref(ndim),
        ctypes.byref(d_off), ctypes.byref(d_len))
    if rc != 0:
        raise ValueError(f"malformed Example record (native rc={rc})")
    return (tuple(shape[i] for i in range(ndim.value)),
            d_off.value, d_len.value)
