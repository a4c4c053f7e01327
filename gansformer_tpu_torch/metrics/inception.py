"""Inception-v3 feature extractor in PyTorch: the FID / IS / P&R / PPL
backbone (the port's counterpart of ``gansformer_tpu/metrics/inception.py``).

``InceptionV3`` takes NHWC images in [-1, 1], as the JAX module does, and
returns ``(pool [N, 2048], logits [N, C])``; inside it runs NCHW on
cuDNN.  Weights come from a flat ``{'Mixed_5b/b1x1/conv/kernel': ...}``
npz, JAX's layout (``inception_params_from_flat``): one npz gives both
packages the same network.  Without one, the network is the port's own
deterministic uncalibrated draw, and every metric name ends in
``_uncal``.  ``make_extractor`` never downloads and never spawns a
converter.

Where a port of the Flax module goes wrong, and what this one does:

* ``ConvBN`` (no conv bias, no BN scale): ``(x - mean) *
  rsqrt(var + 1e-3) + beta``, then ReLU, in that order.
* Flax ``SAME`` on the 1×7 / 7×1 / 1×3 / 3×1 kernels pads only the long
  side: (0, 3) / (3, 0) / (0, 1) / (1, 0) as (H, W).  Every stride-2
  conv and pool is ``VALID``.
* ``_avg_pool_tf`` excludes the padding from the divisor:
  ``F.avg_pool2d(3, 1, 1, count_include_pad=False)`` (``TFAvgPool``).
  torch's default ``True`` shifts every border feature.
* Layouts: HWIO kernels become OIHW; ``fc/kernel`` [2048, C] becomes
  ``Linear.weight`` [C, 2048].  ``C`` follows the checkpoint: 1008 for
  the reference's graph, 1000 for torchvision or keras weights.
* ``preprocess``: clip, bilinear resize to 299² with antialiasing, then
  a single channel repeated to three.  ``jax.image.resize`` (and TF's,
  which the golden fixture pins) weighs samples by a triangle kernel
  widened by 1/scale when downsampling and renormalized at the borders;
  torch's antialias kernel differs at the borders when downsampling
  (1024² → 299²).  So the resize is two matmuls with resampling matrices
  built in numpy from JAX's formula (``resize_matrix``), once per size.
* TF32: cuDNN runs fp32 convolutions in TF32 by default, which would
  shift every feature.  The forward runs under
  ``core.precision.exact_fp32`` (flags set and restored), so the
  features do not depend on the caller's flags.
* The uncalibrated regime: ``jax.random`` cannot be reproduced, so the
  port draws its own network from ``torch.Generator().manual_seed(seed)``
  with Flax's distributions (``lecun_normal`` kernels: a normal truncated
  at ±2 std with std ``sqrt(1/fan_in) / .87962566103423978``, zero
  biases, BN mean 0, var 1, beta 0), the He rescale ×√2 on every kernel
  (``fc`` included) and the per-dimension probe scales of JAX's
  ``_probe_scales``.  Its numbers are not comparable to JAX's
  uncalibrated numbers.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gansformer_tpu_torch.core.device import resolve_device
from gansformer_tpu_torch.core.precision import exact_fp32

INPUT_SIZE = 299
FEATURES = 2048
BN_EPS = 1e-3
LECUN_TRUNC = .87962566103423978   # std of a unit normal cut at ±2
PROBE_IMAGES = 16

_WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".weights")
CAL_NPZ = os.path.join(_WEIGHTS_DIR, "inception-imagenet.npz")


class TFAvgPool(nn.Module):
    """3×3/1 SAME average pool with TF semantics: the padded positions
    are left out of the divisor."""

    count_include_pad = False

    def forward(self, x):
        return F.avg_pool2d(x, 3, 1, 1,
                            count_include_pad=self.count_include_pad)


class ConvBN(nn.Module):
    """Bias-free conv, inference BN (running stats, beta, no scale),
    ReLU.  ``padding``: 'SAME' (stride 1) or 'VALID'."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: str = "SAME"):
        super().__init__()
        kh, kw = kernel
        assert padding == "VALID" or stride == 1
        pad = (kh // 2, kw // 2) if padding == "SAME" else (0, 0)
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, bias=False)
        self.register_buffer("mean", torch.zeros(cout))
        self.register_buffer("var", torch.ones(cout))
        self.register_buffer("beta", torch.zeros(cout))

    def forward(self, x):
        x = self.conv(x)
        x = ((x - self.mean[:, None, None])
             * torch.rsqrt(self.var + BN_EPS)[:, None, None]
             + self.beta[:, None, None])
        return F.relu(x)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.b1x1 = ConvBN(cin, 64, (1, 1))
        self.b5x5_1 = ConvBN(cin, 48, (1, 1))
        self.b5x5_2 = ConvBN(48, 64, (5, 5))
        self.b3x3dbl_1 = ConvBN(cin, 64, (1, 1))
        self.b3x3dbl_2 = ConvBN(64, 96, (3, 3))
        self.b3x3dbl_3 = ConvBN(96, 96, (3, 3))
        self.pool = TFAvgPool()
        self.bpool = ConvBN(cin, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.b1x1(x)
        b5 = self.b5x5_2(self.b5x5_1(x))
        b3 = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        bp = self.bpool(self.pool(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b3x3 = ConvBN(cin, 384, (3, 3), 2, "VALID")
        self.b3x3dbl_1 = ConvBN(cin, 64, (1, 1))
        self.b3x3dbl_2 = ConvBN(64, 96, (3, 3))
        self.b3x3dbl_3 = ConvBN(96, 96, (3, 3), 2, "VALID")

    def forward(self, x):
        b3 = self.b3x3(x)
        bd = self.b3x3dbl_3(self.b3x3dbl_2(self.b3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.b1x1 = ConvBN(cin, 192, (1, 1))
        self.b7x7_1 = ConvBN(cin, c7, (1, 1))
        self.b7x7_2 = ConvBN(c7, c7, (1, 7))
        self.b7x7_3 = ConvBN(c7, 192, (7, 1))
        self.b7x7dbl_1 = ConvBN(cin, c7, (1, 1))
        self.b7x7dbl_2 = ConvBN(c7, c7, (7, 1))
        self.b7x7dbl_3 = ConvBN(c7, c7, (1, 7))
        self.b7x7dbl_4 = ConvBN(c7, c7, (7, 1))
        self.b7x7dbl_5 = ConvBN(c7, 192, (1, 7))
        self.pool = TFAvgPool()
        self.bpool = ConvBN(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.b1x1(x)
        b7 = self.b7x7_3(self.b7x7_2(self.b7x7_1(x)))
        bd = self.b7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"b7x7dbl_{i}")(bd)
        bp = self.bpool(self.pool(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b3x3_1 = ConvBN(cin, 192, (1, 1))
        self.b3x3_2 = ConvBN(192, 320, (3, 3), 2, "VALID")
        self.b7x7x3_1 = ConvBN(cin, 192, (1, 1))
        self.b7x7x3_2 = ConvBN(192, 192, (1, 7))
        self.b7x7x3_3 = ConvBN(192, 192, (7, 1))
        self.b7x7x3_4 = ConvBN(192, 192, (3, 3), 2, "VALID")

    def forward(self, x):
        b3 = self.b3x3_2(self.b3x3_1(x))
        b7 = self.b7x7x3_1(x)
        for i in range(2, 5):
            b7 = getattr(self, f"b7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.b1x1 = ConvBN(cin, 320, (1, 1))
        self.b3x3_1 = ConvBN(cin, 384, (1, 1))
        self.b3x3_2a = ConvBN(384, 384, (1, 3))
        self.b3x3_2b = ConvBN(384, 384, (3, 1))
        self.b3x3dbl_1 = ConvBN(cin, 448, (1, 1))
        self.b3x3dbl_2 = ConvBN(448, 384, (3, 3))
        self.b3x3dbl_3a = ConvBN(384, 384, (1, 3))
        self.b3x3dbl_3b = ConvBN(384, 384, (3, 1))
        self.pool = TFAvgPool()
        self.bpool = ConvBN(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.b1x1(x)
        b3 = self.b3x3_1(x)
        b3 = torch.cat([self.b3x3_2a(b3), self.b3x3_2b(b3)], dim=1)
        bd = self.b3x3dbl_2(self.b3x3dbl_1(x))
        bd = torch.cat([self.b3x3dbl_3a(bd), self.b3x3dbl_3b(bd)], dim=1)
        bp = self.bpool(self.pool(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """NHWC [-1, 1] at 299² → (pool [N, 2048], logits [N, C])."""

    def __init__(self, num_classes: int = 1008):
        super().__init__()
        self.Conv2d_1a = ConvBN(3, 32, (3, 3), 2, "VALID")
        self.Conv2d_2a = ConvBN(32, 32, (3, 3), 1, "VALID")
        self.Conv2d_2b = ConvBN(32, 64, (3, 3))
        self.Conv2d_3b = ConvBN(64, 80, (1, 1), 1, "VALID")
        self.Conv2d_4a = ConvBN(80, 192, (3, 3), 1, "VALID")
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(FEATURES, num_classes)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b(self.Conv2d_2a(self.Conv2d_1a(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a(self.Conv2d_3b(x))
        x = _max_pool(x)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a",
                     "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        pool = x.mean(dim=(2, 3))
        return pool, self.fc(pool)


# ---------------------------------------------------------------- resize

_RESIZE_MEMO: Dict[Tuple[int, int], np.ndarray] = {}


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of ``jax.image.resize(method='bilinear',
    antialias=True)`` along one axis (``compute_weight_mat`` of
    ``jax/_src/image/scale.py``): a triangle kernel widened by 1/scale
    when downsampling, renormalized per output sample, zero where the
    sample falls outside the input."""
    key = (in_size, out_size)
    if key not in _RESIZE_MEMO:
        inv_scale = np.float32(in_size) / np.float32(out_size)
        kernel_scale = max(float(inv_scale), 1.0)
        sample = ((np.arange(out_size, dtype=np.float64) + 0.5)
                  * float(inv_scale) - 0.5)
        x = np.abs(sample[None, :] - np.arange(in_size)[:, None]) \
            / kernel_scale
        w = np.maximum(0.0, 1.0 - x)
        total = w.sum(axis=0, keepdims=True)
        w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                     w / np.where(total != 0, total, 1), 0.0)
        inside = (sample >= -0.5) & (sample <= in_size - 0.5)
        w = np.where(inside[None, :], w, 0.0)
        _RESIZE_MEMO[key] = np.ascontiguousarray(w.T, np.float32)
    return _RESIZE_MEMO[key]


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC ``x`` → [N, size, size, C] by the two resampling matmuls."""
    n, h, w, c = x.shape
    rh = torch.from_numpy(resize_matrix(h, size)).to(x.device)
    rw = torch.from_numpy(resize_matrix(w, size)).to(x.device)
    with exact_fp32():
        y = torch.einsum("oh,nhwc->nowc", rh, x.float())
        return torch.einsum("pw,nowc->nopc", rw, y)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float NHWC at any resolution → 299×299×3 fp32, still in
    [-1, 1] (the scaling the reference's Inception graph expects)."""
    x = images.float().clamp(-1.0, 1.0)
    if x.shape[1] != INPUT_SIZE or x.shape[2] != INPUT_SIZE:
        assert x.shape[1] == x.shape[2], "square images expected"
        x = resize_bilinear(x, INPUT_SIZE)
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    return x


# ---------------------------------------------------------------- weights

def _torch_key(flat_key: str) -> str:
    parts = flat_key.split("/")
    if parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def inception_params_from_flat(flat: Dict[str, np.ndarray]
                               ) -> Dict[str, torch.Tensor]:
    """JAX's flat layout (``'Mixed_5b/b1x1/conv/kernel'``, ``…/mean``,
    ``…/var``, ``…/beta``, ``'fc/kernel'``, ``'fc/bias'``) → a state
    dict of ``InceptionV3``: HWIO kernels as OIHW, ``fc/kernel`` [2048, C]
    as ``fc.weight`` [C, 2048]."""
    out = {}
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        if k.endswith("conv/kernel"):
            v = v.transpose(3, 2, 0, 1)
        elif k == "fc/kernel":
            v = v.T
        out[_torch_key(k)] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """A flat ``{'a/b/c': array}`` npz (JAX's converter writes one) → a
    state dict."""
    with np.load(path) as z:
        return inception_params_from_flat({k: z[k] for k in z.files})


def _meta_net(num_classes: int = 1008) -> InceptionV3:
    """The module without storage (no init draws): ``load_state_dict(...,
    assign=True)`` gives it its tensors."""
    with torch.device("meta"):
        return InceptionV3(num_classes)


def uncalibrated_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The port's deterministic uncalibrated network: Flax's
    ``lecun_normal`` on every kernel, drawn in module order from one CPU
    generator, zero biases, BN at identity, then ×√2 on every kernel."""
    gen = torch.Generator().manual_seed(int(seed))
    sd = {}
    for name, t in _meta_net().state_dict().items():
        if name.endswith("weight"):
            fan_in = t[0].numel()           # OIHW: I·H·W; Linear: in
            std = float(np.sqrt(1.0 / fan_in)) / LECUN_TRUNC
            w = torch.empty(t.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            sd[name] = w * float(np.sqrt(2.0))
        elif name.endswith("var"):
            sd[name] = torch.ones(t.shape)
        else:                               # bias, mean, beta
            sd[name] = torch.zeros(t.shape)
    return sd


def probe_images(seed: int) -> torch.Tensor:
    """16 images of ``tanh(up(8²) + 0.5·up(32²) + 0.25·noise(299²))``
    from ``Generator(seed + 1)``: low- and high-frequency content."""
    gen = torch.Generator().manual_seed(int(seed) + 1)
    n = PROBE_IMAGES
    coarse = torch.randn((n, 8, 8, 3), generator=gen)
    mid = torch.randn((n, 32, 32, 3), generator=gen)
    fine = torch.randn((n, INPUT_SIZE, INPUT_SIZE, 3), generator=gen)
    return torch.tanh(resize_bilinear(coarse, INPUT_SIZE)
                      + 0.5 * resize_bilinear(mid, INPUT_SIZE)
                      + 0.25 * fine)


def probe_scale(t: torch.Tensor) -> torch.Tensor:
    """Per-dimension ``1 / max(std, 1e-3·median(std) + 1e-20)``, std over
    the batch without Bessel's correction (``jnp.std``), the median of an
    even count the mean of its middle two (``jnp.median``)."""
    s = t.std(dim=0, correction=0)
    floor = 1e-3 * torch.quantile(s, 0.5) + 1e-20
    return 1.0 / torch.maximum(s, floor)


# -------------------------------------------------------------- extractor

class FeatureExtractor:
    """(features, logits) of [-1, 1] NHWC images on ``device``; ``sweep``
    stacks them over batches.  ``params``: a state dict of
    ``InceptionV3`` (``load_params_npz``), or None for the uncalibrated
    network of ``seed``.  ``device=None`` is the card."""

    # seed -> (feature scale, logit scale): the probe costs one forward of
    # 16 images; it depends on the seed alone, so it runs once a process
    _PROBE_MEMO: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.calibrated = params is not None
        if params is None:
            params = uncalibrated_params(seed)
        num_classes = int(params["fc.weight"].shape[0])
        net = _meta_net(num_classes)
        net.load_state_dict(params, assign=True)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.scales = None
        if not self.calibrated:
            self.scales = tuple(s.to(self.device)
                                for s in self._probe_scales(seed))

    def _raw(self, images: torch.Tensor):
        with torch.no_grad(), exact_fp32():
            return self.net(preprocess(images))

    def _probe_scales(self, seed: int):
        if seed not in self._PROBE_MEMO:
            feats, logits = self._raw(probe_images(seed).to(self.device))
            self._PROBE_MEMO[seed] = (probe_scale(feats).cpu(),
                                      probe_scale(logits).cpu())
        return self._PROBE_MEMO[seed]

    def __call__(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """(features [N, 2048], logits [N, C]) on the extractor's device."""
        x = torch.as_tensor(np.asarray(images, np.float32)) \
            if not isinstance(images, torch.Tensor) else images
        f, logits = self._raw(x.to(self.device))
        if self.scales is not None:
            f, logits = f * self.scales[0], logits * self.scales[1]
        return f, logits

    def sweep(self, image_batches: Iterable, max_images: int
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Iterate [-1,1]-float batches → stacked host (features,
        logits) of the first ``max_images``."""
        feats, logits = [], []
        seen = 0
        for batch in image_batches:
            f, lg = self(batch)
            take = min(len(f), max_images - seen)
            feats.append(f[:take].cpu().numpy())
            logits.append(lg[:take].cpu().numpy())
            seen += take
            if seen >= max_images:
                break
        return np.concatenate(feats), np.concatenate(logits)


def _npz_loads(path: str) -> bool:
    """A truncated npz (a killed writer) is never trusted."""
    try:
        with np.load(path) as z:
            return len(z.files) > 0
    except Exception:
        return False


def resolve_weights(weights_path: Optional[str] = None) -> Optional[str]:
    """The calibrated weights to load, in order: ``weights_path``,
    ``$GANSFORMER_TPU_INCEPTION_NPZ``, ``.weights/inception-imagenet.npz``
    where it loads; None for the uncalibrated network.  Reads the disk
    only: no network, no subprocess."""
    for path in (weights_path,
                 os.environ.get("GANSFORMER_TPU_INCEPTION_NPZ")):
        if path and os.path.exists(path):
            return path
    if os.path.exists(CAL_NPZ) and _npz_loads(CAL_NPZ):
        return CAL_NPZ
    return None


def make_extractor(weights_path: Optional[str] = None,
                   device: Union[str, torch.device, None] = None
                   ) -> FeatureExtractor:
    """The extractor of ``resolve_weights``' npz, else the uncalibrated
    one (metric names then end in ``_uncal``)."""
    path = resolve_weights(weights_path)
    if path is not None:
        return FeatureExtractor(load_params_npz(path), device=device)
    return FeatureExtractor(None, device=device)
