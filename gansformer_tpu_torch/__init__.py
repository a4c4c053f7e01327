"""gansformer_tpu_torch: the PyTorch + CUDA port of the GANsformer
generator, for NVIDIA Hopper (H100).

Beside ``gansformer_tpu`` (the JAX reference) and independent of it: this
package imports ``torch`` and numpy only.  Layouts match the JAX package
(NHWC activations, HWIO conv weights).  Tensors on the card run the
hand-written kernels under ``csrc/``; tensors on the CPU run each
kernel's plain PyTorch version.  Entry points default to the card and
raise without one unless called with ``device="cpu"``.
"""

__version__ = "0.1.0"
