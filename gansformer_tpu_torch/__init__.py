"""gansformer_tpu_torch: the PyTorch + CUDA port of GANsformer, for NVIDIA
Hopper (H100): the generator's serving path and first-order training of
the generator and discriminator, attention included (D's too).

Beside ``gansformer_tpu`` (the JAX reference) and independent of it: this
package imports ``torch`` and numpy only.  Layouts match the JAX package
(NHWC activations, HWIO conv weights).  Tensors on the card run the
hand-written kernels under ``csrc/`` (inside ``autograd.Function``s whose
backward launches the backward kernels when a graph is recorded);
tensors on the CPU run each kernel's plain PyTorch version.  Entry points
default to the card and raise without one unless called with
``device="cpu"``.
"""

__version__ = "0.3.0"
