"""Generate an image grid with the PyTorch port.

    python -m gansformer_tpu_torch.cli.generate --preset ffhq256-duplex \\
        --seeds 0-7 --truncation-psi 0.7 [--params-npz P] --out grid.png

Weights come from ``--params-npz`` (exported JAX params, see
``gansformer_tpu_torch/bridge.py``) or, without it, from a random init
(seed 0).  Runs on the card unless ``--device cpu``.  The
PNG is written with the standard library (``zlib``/``struct``), so no
imaging package is needed.
"""

from __future__ import annotations

import argparse
import math
import struct
import zlib
from typing import List

import numpy as np
import torch

from gansformer_tpu_torch.bridge import load_flax_params, load_params_npz
from gansformer_tpu_torch.core.config import (get_preset,
                                              model_config_from_json)
from gansformer_tpu_torch.models.generator import Generator
from gansformer_tpu_torch.serve.programs import (ServePrograms, bucket_for,
                                                 bundle_from_generator,
                                                 init_generator)


def parse_seeds(spec: str) -> List[int]:
    """'0-7' or '1,5,9' or '0-3,10'."""
    out: List[int] = []
    for part in (p.strip() for p in spec.split(",")):
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    if not out:
        raise ValueError(f"no seeds in {spec!r}")
    return out


def to_uint8(images: np.ndarray) -> np.ndarray:
    """float [N,H,W,C] in [-1, 1] -> uint8."""
    img = (np.asarray(images, np.float32) + 1.0) * 127.5
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray) -> np.ndarray:
    """[N,H,W,C] uint8 -> one [GH*H, GW*W, C] tile image."""
    n, h, w, c = images.shape
    gw = max(1, int(math.sqrt(n)))
    gh = (n + gw - 1) // gw
    canvas = np.zeros((gh * h, gw * w, c), dtype=np.uint8)
    for i in range(n):
        r, col = divmod(i, gw)
        canvas[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    return canvas


def png_bytes(img: np.ndarray) -> bytes:
    """8-bit RGB (or gray) PNG of a [H, W, 3|1] uint8 array."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    channels = img.shape[2] if img.ndim == 3 else 1
    color = {1: 0, 3: 2, 4: 6}[channels]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="ffhq256-duplex")
    p.add_argument("--config", default=None,
                   help="a JAX run's config.json (its model section wins "
                        "over --preset)")
    p.add_argument("--params-npz", default=None)
    p.add_argument("--seeds", default="0-7")
    p.add_argument("--truncation-psi", type=float, default=0.7)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--out", default="grid.png")
    args = p.parse_args(argv)

    if args.config:
        with open(args.config) as f:
            cfg = model_config_from_json(f.read())
    else:
        cfg = get_preset(args.preset)
    if args.params_npz:
        flat, w_avg = load_params_npz(args.params_npz)
        g = load_flax_params(Generator(cfg), flat)
        bundle = bundle_from_generator(
            g, None if w_avg is None else torch.from_numpy(w_avg),
            device=args.device)
    else:
        bundle = init_generator(cfg, seed=0, device=args.device)
    progs = ServePrograms(bundle)
    seeds = parse_seeds(args.seeds)
    top = progs.buckets[-1]
    images = []
    for i in range(0, len(seeds), top):
        chunk = seeds[i:i + top]
        bucket = bucket_for(len(chunk), progs.buckets)
        padded = chunk + [chunk[-1]] * (bucket - len(chunk))
        ws = progs.map_seeds(padded)
        img = progs.synthesize(ws, [args.truncation_psi] * bucket,
                               tags=padded)
        images.append(img[:len(chunk)].cpu().numpy())
    grid = make_grid(to_uint8(np.concatenate(images)))
    with open(args.out, "wb") as f:
        f.write(png_bytes(grid))
    print(f"wrote {args.out}: {len(seeds)} images {grid.shape} on "
          f"{bundle.device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
