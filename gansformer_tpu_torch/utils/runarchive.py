"""Packed run-dir archives (the port's copy of
``gansformer_tpu/utils/runarchive.py``, local archives only).

The distributable unit of a run is a tarball of ``config.json`` and one
checkpoint step (``run/config.json``, ``run/checkpoints/<step>/``):
``pack_run`` writes one, ``resolve_run_dir`` takes a run dir or a local
``.tar`` / ``.tar.gz`` of one and hands back a usable run dir.  The
archives are the JAX package's, so each package reads the other's.  An
``http(s)://`` spec is refused: fetching it needs the network.
"""

from __future__ import annotations

import hashlib
import os
import tarfile
from typing import Optional


def pack_run(run_dir: str, out_path: Optional[str] = None,
             step: Optional[int] = None) -> str:
    """Pack ``config.json`` and one checkpoint step (default: the latest)
    into a ``.tar.gz``; returns its path."""
    from gansformer_tpu_torch.train import checkpoint as ckpt

    cfg = os.path.join(run_dir, "config.json")
    if not os.path.exists(cfg):
        raise FileNotFoundError(f"no config.json under {run_dir}")
    ckpt_root = os.path.join(run_dir, "checkpoints")
    if step is None:
        step = ckpt.latest_step(ckpt_root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_root}")
    step_dir = os.path.join(ckpt_root, str(step))
    if not os.path.isdir(step_dir):
        raise FileNotFoundError(f"no checkpoint step {step} in {ckpt_root}")
    out_path = out_path or os.path.join(
        os.path.dirname(os.path.normpath(run_dir)) or ".",
        f"{os.path.basename(os.path.normpath(run_dir))}-step{step}.tar.gz")
    with tarfile.open(out_path, "w:gz") as t:
        t.add(cfg, arcname="run/config.json")
        t.add(step_dir, arcname=f"run/checkpoints/{step}")
    return out_path


def resolve_run_dir(spec: str, cache_dir: Optional[str] = None) -> str:
    """A run dir -> itself; a ``.tar(.gz)`` path -> a cached extraction of
    the packed run (keyed by the archive's path, size and mtime, so a
    re-pack to the same path is extracted anew).  ``cache_dir`` defaults
    to ``.runarchive`` beside the archive."""
    if spec.startswith(("http://", "https://")):
        raise ValueError(
            f"{spec!r}: run archives over http(s) are not in the PyTorch "
            f"port (fetching one needs the network); download the "
            f"archive on a host that has it and pass its local path")
    if os.path.isdir(spec):
        return spec
    if not os.path.isfile(spec):
        raise FileNotFoundError(
            f"{spec!r} is neither a run dir nor an archive")
    archive = spec
    cache_dir = cache_dir or os.path.join(
        os.path.dirname(os.path.abspath(archive)), ".runarchive")
    st = os.stat(archive)
    key = hashlib.sha256(
        f"{os.path.abspath(archive)}:{st.st_size}:{st.st_mtime_ns}"
        .encode()).hexdigest()[:16]
    out = os.path.join(cache_dir, key, "extracted")
    marker = os.path.join(out, ".extracted")
    if not os.path.exists(marker):
        os.makedirs(out, exist_ok=True)
        with tarfile.open(archive) as t:
            t.extractall(out, filter="data")
        with open(marker, "w") as f:
            f.write("ok\n")
    run = os.path.join(out, "run")
    if not os.path.exists(os.path.join(run, "config.json")):
        raise FileNotFoundError(
            f"archive {spec!r} holds no run/config.json — not a pack_run "
            f"archive")
    return run
