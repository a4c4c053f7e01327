"""Image grids (the port's copy of ``to_uint8``, ``make_grid``,
``save_image_grid``, ``attention_overlay`` and ``save_attention_grid`` of
``gansformer_tpu/utils/image.py``): every tick the loop writes
``fakes<kimg>.png``, and the generate CLI its grids and attention
overlays.  The PNG is written with ``zlib`` and ``struct`` (8-bit grey
or RGB, filter 0), because the card's machine has no Pillow."""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Tuple

import numpy as np


def to_uint8(images: np.ndarray, drange: Tuple[float, float] = (-1, 1)
             ) -> np.ndarray:
    """float [N,H,W,C] in drange → uint8."""
    lo, hi = drange
    img = (np.asarray(images, dtype=np.float32) - lo) * (255.0 / (hi - lo))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray,
              grid: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """[N,H,W,C] uint8 → one [GH*H, GW*W, C] tile image."""
    n, h, w, c = images.shape
    if grid is None:
        gw = max(1, int(math.sqrt(n)))
        gh = (n + gw - 1) // gw
    else:
        gw, gh = grid
    canvas = np.zeros((gh * h, gw * w, c), dtype=np.uint8)
    for i in range(min(n, gw * gh)):
        r, col = divmod(i, gw)
        canvas[r * h:(r + 1) * h, col * w:(col + 1) * w] = images[i]
    return canvas


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 [H, W] (grey) or [H, W, 3] (RGB) → PNG bytes."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        color = 0
    elif arr.ndim == 3 and arr.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"PNG takes [H, W] or [H, W, 3], got {arr.shape}")
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The inverse of ``encode_png`` (8-bit, unfiltered rows, one IDAT
    run), for checks where Pillow is missing."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    if depth != 8 or color not in (0, 2):
        raise ValueError(f"unsupported PNG: depth {depth}, color {color}")
    c = 3 if color == 2 else 1
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * c)
    if raw[:, 0].any():
        raise ValueError("filtered PNG rows are not supported")
    out = raw[:, 1:].reshape(h, w, c)
    return out[..., 0] if c == 1 else out


def save_image_grid(images, path: str, drange: Tuple[float, float] = (-1, 1),
                    grid: Optional[Tuple[int, int]] = None) -> None:
    arr = make_grid(to_uint8(np.asarray(images), drange), grid)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    with open(path, "wb") as f:
        f.write(encode_png(arr))


# Distinct colors for up to 32 latent components (k ≤ 32 in every config).
_COMPONENT_COLORS = np.array(
    [[230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
     [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
     [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
     [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
     [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
     [255, 255, 255], [0, 0, 0], [233, 109, 109], [109, 233, 168],
     [109, 150, 233], [233, 208, 109], [176, 109, 233], [109, 233, 233],
     [233, 109, 187], [150, 150, 80], [80, 150, 150], [150, 80, 150]],
    dtype=np.float32)


def attention_overlay(images: np.ndarray, probs: np.ndarray,
                      alpha: float = 0.55) -> np.ndarray:
    """Latent->region assignment maps blended over the images (the
    GANsformer paper's attention figure).  images: [N,H,W,3] float in
    [-1,1]; probs: [N,h,w,k] row-stochastic over k, nearest-upsampled to
    the image size.  Returns uint8 [N,H,W,3]: the grey image under a
    per-component colour segmentation weighted by confidence."""
    imgs = to_uint8(images).astype(np.float32)
    n, H, W, _ = imgs.shape
    k = probs.shape[-1]
    ph, pw = probs.shape[1:3]
    probs = np.asarray(probs, np.float32)
    probs = probs[:, np.repeat(np.arange(ph), H // ph), :, :][
        :, :, np.repeat(np.arange(pw), W // pw), :]
    colors = _COMPONENT_COLORS[np.arange(k) % len(_COMPONENT_COLORS)]
    seg = probs @ colors                                # [N,H,W,3]
    gray = imgs.mean(axis=-1, keepdims=True)
    out = (1 - alpha) * np.broadcast_to(gray, imgs.shape) + alpha * seg
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def save_attention_grid(images, probs, path: str,
                        grid: Optional[Tuple[int, int]] = None) -> None:
    """The attention-overlay grid PNG (generate ``--save-attention``)."""
    arr = make_grid(attention_overlay(np.asarray(images), np.asarray(probs)),
                    grid)
    with open(path, "wb") as f:
        f.write(encode_png(arr))
