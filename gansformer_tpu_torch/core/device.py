"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  With no
card and no explicit CPU request they raise: nothing quietly runs on the
host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  Raises when the card is asked for (or
    defaulted to) and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def wants_graph(*ts) -> bool:
    """True when autograd is recording and any of ``ts`` (tensors or None)
    requires grad: a kernel op must then build its own graph node (an
    ``autograd.Function`` whose backward launches kernels), since a raw
    launch returns a tensor with no ``grad_fn``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def kernel_route(t: torch.Tensor) -> bool:
    """True when ``t`` lies on the card (launch the kernel), False on the
    CPU (run the plain version).  Any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"tensor on unsupported device {t.device}")
