"""Training data of the port: the JAX package's procedural source and the
uint8 -> [-1, 1] normalization (counterparts of ``SyntheticDataset`` and
``normalize_images`` in ``gansformer_tpu/data/dataset.py``; numpy only).
Real datasets (TFRecords) come with the tick loop."""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from gansformer_tpu_torch.core.precision import widen


def normalize_images(uint8_images: torch.Tensor) -> torch.Tensor:
    """uint8 [N,H,W,C] -> float32 in [-1, 1], on the tensor's device."""
    return widen(uint8_images) / 127.5 - 1.0


class SyntheticDataset:
    """Deterministic procedural images: smooth multi-scale Gabor-like
    blobs, image i a function of i alone (a copy of the JAX package's
    ``SyntheticDataset._make``, so both packages see the same reals)."""

    def __init__(self, resolution: int = 64, channels: int = 3,
                 num_images: int = 10000):
        self.resolution = resolution
        self.channels = channels
        self.num_images = num_images

    def _make(self, idx: np.ndarray) -> np.ndarray:
        r, c = self.resolution, self.channels
        yy, xx = np.mgrid[0:r, 0:r].astype(np.float32) / r
        imgs = np.empty((len(idx), r, r, c), dtype=np.uint8)
        for i, seed in enumerate(idx):
            rs = np.random.RandomState(int(seed) % (2**31))
            img = np.zeros((r, r, c), np.float32)
            for _ in range(4):
                fx, fy = rs.uniform(1, 6, 2)
                px, py = rs.uniform(0, 2 * np.pi, 2)
                cx, cy = rs.uniform(0.2, 0.8, 2)
                sig = rs.uniform(0.1, 0.4)
                blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                                / (2 * sig**2)))
                wave = np.sin(2 * np.pi * (fx * xx + px)) * np.sin(
                    2 * np.pi * (fy * yy + py))
                col = rs.uniform(-1, 1, c).astype(np.float32)
                img += (blob * wave)[..., None] * col
            img = np.tanh(img)
            imgs[i] = ((img * 0.5 + 0.5) * 255).astype(np.uint8)
        return imgs

    def batches(self, batch_size: int, seed: int = 0) -> Iterator[np.ndarray]:
        """Endless uint8 [batch, R, R, C] batches of random image indices,
        the index stream of the JAX ``batches`` on one host."""
        rs = np.random.RandomState(seed)
        while True:
            yield self._make(rs.randint(0, self.num_images, size=batch_size))
