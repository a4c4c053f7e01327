"""Warm start of the kernel library: the port's counterpart of
``gansformer_tpu/serve/warmstart.py``.

A JAX serving process compiles one executable per (program, bucket), and
its warm start deserializes them from a manifest.  The port runs its
programs eagerly and compiles nothing per program: its cold cost is the
``nvcc`` build of ``csrc/*.cu`` into one shared library.  So the warm
start builds that library ahead of time into a manifest directory and
records beside it what the file is valid for; a later process that finds
a valid entry loads the file with no build.

Layout (``manifest_dir``, default ``gansformer_tpu_torch/_build/``, the
directory the kernels build into at first use)::

    manifest.json                         {"version": 1, "entries": {...}}
    <digest>/libgansformer_kernels.so     ops/_build.py's own layout

The entry ``"kernels"``::

    {"file": "<digest>/libgansformer_kernels.so", "sha256": "...",
     "signature": {"sources": digest of the sources, flags and toolkit,
                   "nvcc": "nvcc --version", "arch_flags": [...],
                   "nvcc_flags": [...], "torch": "2.x", "device": name,
                   "capability": [9, 0]},
     "written_at": 1700000000.0}

The library has a plain C interface and is loaded with ``ctypes``, so
it is valid for its sources, toolkit, flags and the card's compute
capability (``VALID_FOR``); torch's version and the card's name are
recorded, not compared.  A torn manifest, a signature that differs in
``VALID_FOR`` (an edited source, another toolkit, flags or
capability), a missing file, a checksum that differs or a file that
fails to load is stale: it is counted in ``serve/manifest_stale_total``,
the library is rebuilt from the sources and the entry rewritten.  A
valid entry counts ``serve/warm_hits_total`` and a build
``serve/compiles_total``.  A library that the lazy build already put in
the directory, with no entry (an untorn manifest without one, or none),
is adopted: loaded, and its entry written, with no build.  Stale never
means the plain path: a library that fails to build raises.

``lib`` is the library being warmed: ``ops/_build.py`` itself, or any
object with its ``signature``, ``library_path``, ``build``, ``load_path``
and ``loaded`` (the tests use a g++ stand-in, since the host has no
``nvcc``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.obs.registry import atomic_write_text
from gansformer_tpu_torch.ops import _build

MANIFEST = "manifest.json"
VERSION = 1
ENTRY = "kernels"
# The keys of the signature an entry must match to be loaded.
VALID_FOR = ("sources", "nvcc", "arch_flags", "nvcc_flags", "capability")


def default_manifest_dir() -> str:
    """The package's build directory, where the kernels build at first
    use (git-ignored)."""
    return _build.BUILD_ROOT


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _read_manifest(manifest_dir: str) -> Tuple[Dict[str, Any], bool]:
    """(entries, torn): a missing manifest has no entries and is not torn;
    one that does not parse to this layout is torn and has none."""
    path = os.path.join(manifest_dir, MANIFEST)
    if not os.path.exists(path):
        return {}, False
    try:
        with open(path) as f:
            data = json.load(f)
        if data.get("version") != VERSION or not isinstance(
                data.get("entries"), dict):
            raise ValueError("bad manifest layout")
        return data["entries"], False
    except (ValueError, OSError, AttributeError):
        return {}, True


def _check(entry: Dict[str, Any], sig: Dict[str, Any], path: str,
           manifest_dir: str) -> None:
    """Raise ValueError unless ``entry`` is valid for ``sig`` and names
    the file at ``path`` with its checksum."""
    have = entry.get("signature")
    if not isinstance(have, dict) or any(have.get(k) != sig[k]
                                         for k in VALID_FOR):
        raise ValueError("stale signature")
    if os.path.join(manifest_dir, str(entry.get("file"))) != path:
        raise ValueError("the entry names another file")
    if not os.path.exists(path):
        raise ValueError("library file missing")
    if _sha256(path) != entry.get("sha256"):
        raise ValueError("checksum mismatch")


def _remove_build_dir(manifest_dir: str, path: str) -> None:
    """Remove the directory holding ``path`` when it lies strictly inside
    ``manifest_dir`` (a stale build).  It is renamed aside first, so its
    path never names a half-removed build."""
    root = os.path.realpath(manifest_dir)
    d = os.path.realpath(os.path.dirname(path))
    if d == root or not d.startswith(root + os.sep) or not os.path.isdir(d):
        return
    aside = tempfile.mkdtemp(dir=root, prefix="stale-")
    try:
        os.replace(d, os.path.join(aside, "build"))
    except OSError:                  # another process moved it first
        pass
    shutil.rmtree(aside, ignore_errors=True)


def _record(manifest_dir: str, entries: Dict[str, Any], path: str,
            sig: Dict[str, Any]) -> None:
    entries[ENTRY] = {"file": os.path.relpath(path, manifest_dir),
                      "sha256": _sha256(path), "signature": sig,
                      "written_at": time.time()}
    atomic_write_text(os.path.join(manifest_dir, MANIFEST), json.dumps(
        {"version": VERSION, "entries": entries}, indent=1,
        sort_keys=True))


def warm_start(manifest_dir: str, lib: Any = None) -> Dict[str, Any]:
    """Load the library from ``manifest_dir`` when its entry is valid, or
    build it there and write the entry.  Returns {loaded, compiled,
    seconds, path} with the counts 0 or 1."""
    lib = lib or _build
    t0 = time.perf_counter()
    os.makedirs(manifest_dir, exist_ok=True)
    sig = lib.signature()
    path = lib.library_path(manifest_dir)
    entries, stale = _read_manifest(manifest_dir)
    entry = entries.get(ENTRY)
    if entry is not None:
        try:
            _check(entry, sig, path, manifest_dir)
            lib.load_path(path)
        except (ValueError, OSError, AttributeError):
            stale = True
            if isinstance(entry, dict):        # the stale entry's build
                _remove_build_dir(manifest_dir, os.path.join(
                    manifest_dir, str(entry.get("file"))))
        else:
            telemetry.counter("serve/warm_hits_total").inc()
            return {"loaded": 1, "compiled": 0,
                    "seconds": time.perf_counter() - t0, "path": path}
    elif not stale and os.path.exists(path):
        try:                       # the lazy build's library: adopt it
            lib.load_path(path)
        except OSError:
            stale = True
        else:
            _record(manifest_dir, entries, path, sig)
            return {"loaded": 1, "compiled": 0,
                    "seconds": time.perf_counter() - t0, "path": path}
    if stale:
        telemetry.counter("serve/manifest_stale_total").inc()
        _remove_build_dir(manifest_dir, path)   # nothing vouches for it
    built = lib.build(manifest_dir)
    lib.load_path(built)
    _record(manifest_dir, entries, built, sig)
    telemetry.counter("serve/compiles_total").inc()
    return {"loaded": 0, "compiled": 1,
            "seconds": time.perf_counter() - t0, "path": built}


def cold_start(build_root: Optional[str] = None,
               lib: Any = None) -> Dict[str, Any]:
    """Load the library as the kernels' first use does (built into
    ``build_root`` unless it is there), recording nothing.  A library
    this process already loaded counts as neither loaded nor built."""
    lib = lib or _build
    t0 = time.perf_counter()
    if lib.loaded():
        return {"loaded": 0, "compiled": 0, "seconds": 0.0, "path": None}
    existed = os.path.exists(lib.library_path(build_root))
    path = lib.build(build_root)
    lib.load_path(path)
    if not existed:
        telemetry.counter("serve/compiles_total").inc()
    return {"loaded": 0, "compiled": int(not existed),
            "seconds": time.perf_counter() - t0, "path": path}
