"""Compute precision of the plain path: the fp32 islands, and a host-only
float64 reference mode.

The port computes in bf16 or fp32 with fp32 islands (the softmax
statistics, demodulation, instance norm, the mapping network, the logit
head and the loss reductions), as the JAX package does.  ``widen`` is an
island's cast: bf16 and fp32 become fp32, float64 stays float64.  So a
model built with ``ModelConfig(dtype="float64")`` on the CPU runs every
op, islands included, in float64; its parameters stay fp32 (exact in
float64) and take fp32 gradients.

That mode is the reference of the card-vs-host gradient checks
(``chip_smoke.py``): at random init an lrelu input within fp32 rounding
of zero takes either slope, so two fp32 runs of the same step disagree
by more than their summation order, and only a run whose rounding is far
below theirs tells which is closer.  It exists on the host only: the
kernels take fp32 and bf16, so a float64 tensor on the card raises
(``core.device.kernel_route``), and ``core.config.validate`` refuses the
dtype as the JAX package does, so no ``config.json`` reaches it.
"""

from __future__ import annotations

import torch

REFERENCE = torch.float64


def widen(t: torch.Tensor) -> torch.Tensor:
    """An fp32 island's cast: fp32 for bf16 and fp32, float64 kept."""
    return t if t.dtype == REFERENCE else t.float()


def island_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.dtype:
    """The dtype a layer of fixed ``dtype`` computes ``x`` in: its own,
    or float64 for a float64 input (the reference mode)."""
    return REFERENCE if x.dtype == REFERENCE else dtype


def input_dtype(model_dtype: str) -> torch.dtype:
    """The dtype of a step's latents and reals: fp32, or float64 for a
    float64 model."""
    return REFERENCE if model_dtype == "float64" else torch.float32
