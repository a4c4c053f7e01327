"""int8 weight-only quantization of the serving synth program
(``serve_precision='int8w'``): the counterpart of
``gansformer_tpu/serve/quant.py``.

Every equalized-LR kernel (the ``w`` of ``EqualDense``, ``EqualConv`` and
``ModulatedConv``: ndim 2 or 4) becomes int8 codes plus one fp32 scale per
output channel over the last axis, ``scale_c = max|w[..., c]| / 127``,
``q = round(w / scale)``; an all-zero channel takes scale 1.  Everything
else (biases, noise strengths, the attention tables, ``const``, the
gates) stays fp32.  The scales are derived at bundle load in numpy, with
no randomness, so the codes equal the JAX package's bit for bit for the
same weights.  They stay int8 and fp32 on the device, as buffers of a
``QuantizedWeight``; the layers dequantize them in ``ops.resolve_weight``,
an fp32 island, and the kernels take the dequantized weights.

``cost_report`` and ``fidelity_report`` are the A/B: the bytes each
precision's synth program holds and its peak device memory around one
``synthesize`` (``torch.cuda.memory_stats``; ``None`` on the CPU, where
JAX reads XLA's ``memory_analysis``; ``flops_per_image`` has no torch
counterpart and is ``None``), and each precision's output error against
the f32 program on the same mapped rows.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from gansformer_tpu_torch.ops.modulated_conv import QuantizedWeight

# max |out - ref| / max |ref| allowed against the f32 program, per
# precision: the JAX package's declared tolerances (f32 is the reference;
# bf16 rounds the activations; int8w adds ~0.4 % per weight on top).
FIDELITY_TOLERANCES: Dict[str, float] = {
    "f32": 0.0,
    "bf16": 0.05,
    "int8w": 0.20,
}


def is_kernel(name: str, leaf) -> bool:
    """The quantization predicate: a leaf named ``w`` (the last part of a
    ``/``- or ``.``-joined name) with ndim 2 or 4."""
    return (name.replace(".", "/").split("/")[-1] == "w"
            and getattr(leaf, "ndim", 0) in (2, 4))


def quantize_leaf(w) -> QuantizedWeight:
    """One kernel -> ``QuantizedWeight`` (int8 codes of its shape, fp32
    scales of each output channel over the last axis, keepdims)."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)), keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    scale = np.where(scale > 0.0, scale, np.float32(1.0)).astype(np.float32)
    q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    return QuantizedWeight(torch.from_numpy(q), torch.from_numpy(scale))


def quantize_params(params: Mapping[str, Any]) -> Dict[str, Any]:
    """A flat parameter dict (the bridge's ``/``-joined names) with every
    kernel replaced by its ``QuantizedWeight``; other leaves unchanged."""
    return {k: quantize_leaf(v) if is_kernel(k, v) else v
            for k, v in params.items()}


def quantize_module(module: nn.Module) -> nn.Module:
    """Replace, in place, every kernel parameter of ``module`` by the
    ``QuantizedWeight`` of its fp32 values (taken to the host, quantized
    there, put back on the parameter's device)."""
    for sub in list(module.modules()):
        w = sub._parameters.get("w")
        if w is None or not is_kernel("w", w):
            continue
        qw = quantize_leaf(w.detach().float().cpu().numpy()).to(w.device)
        del sub._parameters["w"]
        sub.w = qw
    return module


def param_tree_bytes(tree) -> int:
    """Bytes of a parameter tree: a module's ``state_dict`` (a
    ``QuantizedWeight`` gives its int8 codes and fp32 scales), or a flat
    mapping of arrays and ``QuantizedWeight``s."""
    if isinstance(tree, nn.Module):
        leaves = list(tree.state_dict().values())
    else:
        leaves = []
        for v in tree.values():
            leaves += ([v.q, v.scale] if isinstance(v, QuantizedWeight)
                       else [v])
    total = 0
    for t in leaves:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        else:
            total += int(np.prod(np.shape(t))) * np.dtype(t.dtype).itemsize
    return int(total)


# -- A/B reports -------------------------------------------------------------

def _programs(bundle, precision: str, bucket: int):
    from gansformer_tpu_torch.serve.programs import ServePrograms

    return ServePrograms(bundle, buckets=(bucket,), serve_precision=precision)


def _peak_bytes(progs, ws, psi, seeds) -> Dict[str, Optional[float]]:
    """Peak device memory of one synthesize above what was allocated
    before it, and the output's bytes; ``None`` off the card."""
    if progs.device.type != "cuda":
        return {"peak_bytes": None, "output_bytes": None}
    torch.cuda.synchronize(progs.device)
    base = torch.cuda.memory_stats(progs.device)["allocated_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats(progs.device)
    out = progs.synthesize(ws, psi, seed=7, tags=seeds)
    torch.cuda.synchronize(progs.device)
    peak = torch.cuda.memory_stats(progs.device)["allocated_bytes.all.peak"]
    return {"peak_bytes": float(peak - base),
            "output_bytes": float(out.numel() * out.element_size())}


def cost_report(bundle, bucket: int = 4,
                precisions: Sequence[str] = ("f32", "bf16", "int8w")
                ) -> Dict[str, Any]:
    """Per precision at one bucket: the bytes the synth program holds
    (``params_tree_bytes``, counted), the request rows' bytes, and on the
    card the peak device memory of one synthesize above its inputs
    (``peak_bytes``) and the output's bytes per image; ratios against
    f32."""
    out: Dict[str, Any] = {"bucket": int(bucket), "per_precision": {}}
    seeds = list(range(1, bucket + 1))
    psi = [0.7] * bucket
    for prec in precisions:
        p = _programs(bundle, prec, bucket)
        ws = p.map_seeds(seeds)
        mem = _peak_bytes(p, ws, psi, seeds)
        tree = param_tree_bytes(p.synth_module)
        req = ws.numel() * ws.element_size() + 8 * bucket  # + psi, tags
        out["per_precision"][prec] = {
            "flops_per_image": None,
            "params_tree_bytes": tree,
            "param_bytes_per_image": tree / bucket,
            "request_bytes": float(req),
            "peak_bytes": mem["peak_bytes"],
            "output_bytes_per_image": (None if mem["output_bytes"] is None
                                       else mem["output_bytes"] / bucket),
        }
    f32 = out["per_precision"].get("f32", {})
    for prec in precisions:
        if prec == "f32":
            continue
        rec = out["per_precision"][prec]
        for num, den, key in (
                (f32.get("param_bytes_per_image"),
                 rec.get("param_bytes_per_image"), "param_bytes_ratio"),
                (f32.get("params_tree_bytes"),
                 rec.get("params_tree_bytes"), "tree_bytes_ratio"),
                (f32.get("flops_per_image"),
                 rec.get("flops_per_image"), "flops_ratio")):
            rec[f"{key}_vs_f32"] = (num / den) if num and den else None
    return out


def fidelity_report(bundle, precision: str, bucket: int = 4,
                    seeds: Optional[Sequence[int]] = None,
                    psi: float = 0.7,
                    tolerance: Optional[float] = None) -> Dict[str, Any]:
    """A precision's output against the f32 program's: the same mapped
    rows (the mapping always runs f32), the same psi, the same noise
    seed and tags, so only the synth program's precision differs.  The
    noise is drawn on the CPU, so a report on the card and one on the
    host see the same inputs.  ``rel_err`` is max |out - ref| / max |ref|,
    graded against the tolerance."""
    if tolerance is None:
        tolerance = FIDELITY_TOLERANCES[precision]
    if seeds is None:
        seeds = list(range(1, bucket + 1))
    seeds = [int(s) for s in seeds]
    if len(seeds) != bucket:
        raise ValueError(f"need exactly {bucket} seeds, got {len(seeds)}")
    ref_p = _programs(bundle, "f32", bucket)
    var_p = _programs(bundle, precision, bucket)
    ws = ref_p.map_seeds(seeds)
    psis = [psi] * bucket
    ref = ref_p.synthesize(ws, psis, seed=7, tags=seeds,
                           noise_device="cpu").float().cpu()
    out = var_p.synthesize(ws, psis, seed=7, tags=seeds,
                           noise_device="cpu").float().cpu()
    denom = float(ref.abs().max()) or 1.0
    abs_err = float((out - ref).abs().max())
    rel_err = abs_err / denom
    return {
        "precision": precision,
        "bucket": int(bucket),
        "psi": float(psi),
        "max_abs_err": abs_err,
        "ref_dynamic_range": denom,
        "rel_err": rel_err,
        "tolerance": float(tolerance),
        "ok": bool(rel_err <= tolerance),
    }
