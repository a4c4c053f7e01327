"""Generate images with the PyTorch port.

From a run (the JAX generate CLI's surface, ``gansformer_tpu/cli/
generate.py``)::

    python -m gansformer_tpu_torch.cli.generate --run-dir R [--grid] \\
        [--images-num 32] [--batch-size 16] [--truncation-psi 0.7] \\
        [--seed 42] [--interpolate ROWS STEPS] [--style-mix ROWS COLS] \\
        [--save-attention] [--out DIR]

``--run-dir`` is a run dir (its ``config.json`` and newest checkpoint, a
port run's or a JAX run's: the format is shared) or a ``pack_run``
archive.  Only the EMA generator and ``w_avg`` are read.  It writes
``img<i>.png`` singles or ``grid.png`` (``--grid``), and optionally
``interp.png`` (z-lerp strips, frames sharing their noise), ``mix.png``
(row sources keep the leading latent components, column sources give
the rest) and ``attn.png`` (latent->region overlays, only with
``--device cpu``: the maps come from the plain path), into ``--out``
(default ``<run>/generated``).  The draws follow the JAX CLI's layout by
tag (``draw_z``): batch ``i``'s latents are tagged ``i`` and its noise
``i + 1``; the strips' endpoints 101 / 202 and noise 303; the mixing
sources 404 / 505 and noise 606; the overlay's 0 / 1.  Each tag seeds
the port's own generator through ``derive_seed(seed, tag)``
(``jax.random`` cannot be reproduced).

From a preset or config and seeds (random init, or ``--params-npz`` of
exported JAX params)::

    python -m gansformer_tpu_torch.cli.generate --preset ffhq256-duplex \\
        --seeds 0-7 --truncation-psi 0.7 [--params-npz P] --out grid.png

Runs on the card unless ``--device cpu``.  PNGs are written with the
standard library (``zlib``/``struct``), so no imaging package is needed.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

from gansformer_tpu_torch.bridge import load_flax_params, load_params_npz
from gansformer_tpu_torch.core.config import (ExperimentConfig, get_preset,
                                              model_config_from_json)
from gansformer_tpu_torch.models.generator import (Generator,
                                                   apply_truncation)
from gansformer_tpu_torch.serve.programs import (ServePrograms, bucket_for,
                                                 bundle_from_generator,
                                                 init_generator,
                                                 noise_generators)
from gansformer_tpu_torch.train.state import derive_seed
from gansformer_tpu_torch.utils.image import (encode_png, make_grid,
                                              save_attention_grid,
                                              save_image_grid, to_uint8)

# JAX generate flags the port does not take, and why.
LATER_FLAGS = {
    "--attention-backend": "has no counterpart: the device picks the path",
    "--conv-backend": "has no counterpart: the device picks the path",
    "--no-warm-start": "comes with the serving slice's warm start (A.4)",
}


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


def png_bytes(img: np.ndarray) -> bytes:
    """8-bit RGB (or grey) PNG of a [H, W, 3|1] uint8 array."""
    img = np.asarray(img, np.uint8)
    return encode_png(img[..., 0] if img.ndim == 3 and img.shape[2] == 1
                      else img)


def draw_z(seed: int, tag: int, n: int, cfg) -> np.ndarray:
    """The latents of ``tag`` (the JAX CLI's fold-in index) of a run of
    ``seed``: [n, num_ws, latent_dim] fp32 from a CPU generator."""
    gen = torch.Generator().manual_seed(derive_seed(seed, "generate", tag))
    return torch.randn((n, cfg.num_ws, cfg.latent_dim),
                       generator=gen).numpy()


def noise_seed_of(seed: int, tag: int) -> int:
    """The noise seed of ``tag`` of a run of ``seed``: row r's noise
    generator is ``noise_seed(noise_seed_of(seed, tag), r)``."""
    return derive_seed(seed, "generate", "noise", tag)


def _pad_rows(a: np.ndarray, bucket: int) -> np.ndarray:
    """A [n, ...] batch padded to ``bucket`` rows by repeating the last
    (rows are independent, so the prefix is unchanged)."""
    if a.shape[0] == bucket:
        return a
    pad = np.broadcast_to(a[-1:], (bucket - a.shape[0],) + a.shape[1:])
    return np.concatenate([a, pad])


def load_run(run_dir: str, device=None):
    """(ExperimentConfig, GeneratorBundle) of a run dir's newest
    checkpoint: the EMA generator and ``w_avg`` only (checked against a
    template state on the host, whose other leaves are never read)."""
    from gansformer_tpu_torch.train import checkpoint as ckpt
    from gansformer_tpu_torch.train.state import create_train_state

    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    template = create_train_state(cfg.model, cfg.train, 0, "cpu")
    got = ckpt.restore_selected(
        os.path.join(run_dir, "checkpoints"), template,
        lambda k: k.startswith("ema_params/") or k == "w_avg")
    del template
    params = {k[len("ema_params/"):]: v for k, v in got.items()
              if k.startswith("ema_params/")}
    g = load_flax_params(Generator(cfg.model), params)
    return cfg, bundle_from_generator(g, torch.from_numpy(got["w_avg"]),
                                      device=device)


def _seeds_main(args) -> int:
    """--preset/--config + --seeds -> one grid PNG."""
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
    out = args.out or "grid.png"
    with open(out, "wb") as f:
        f.write(png_bytes(grid))
    print(f"wrote {out}: {len(seeds)} images {grid.shape} on "
          f"{bundle.device}")
    return 0


def attention_maps(bundle, z: np.ndarray, psi: float, seed: int,
                   label=None):
    """The overlay's run of a bundle on the host's CPU: (images
    [N,R,R,C], maps [N,h,w,k] of the finest attention resolution,
    averaged over heads).  The probabilities come from the plain path
    (the kernels never write them), so the CLI takes ``--save-attention``
    only with ``--device cpu``."""
    cfg = bundle.cfg
    if cfg.attention == "none":
        raise SystemExit("--save-attention needs an attention model")
    g = bundle.generator
    res = max(cfg.attn_resolutions())
    block = getattr(g.synthesis, f"b{res}_attn")
    block.probs_sink = []
    try:
        with torch.inference_mode():
            ws = g.map(torch.from_numpy(np.array(z, np.float32)), label)
            ws = apply_truncation(ws, bundle.w_avg, psi)
            imgs = g.synthesize(ws, noise_gens=noise_generators(
                noise_seed_of(seed, 1), range(z.shape[0]), bundle.device))
        probs = block.probs_sink[0].float().mean(dim=1)  # heads: [N,h,w,k]
    finally:
        block.probs_sink = None
    return imgs.float().numpy(), probs.numpy()


def _run_main(args) -> int:
    from gansformer_tpu_torch.utils.runarchive import resolve_run_dir

    if args.save_attention and torch.device(
            args.device or "cuda").type != "cpu":
        raise SystemExit(
            "--save-attention needs --device cpu: its maps come from the "
            "plain path on the host (the kernels never write the attention "
            "probabilities), so the whole run is the host's")
    run_dir = resolve_run_dir(args.run_dir)
    cfg, bundle = load_run(run_dir, args.device)
    m = cfg.model
    bs = args.batch_size
    progs = ServePrograms(bundle, buckets=(bs,))
    dataset = None
    if m.label_dim:
        from gansformer_tpu_torch.data.dataset import make_dataset

        dataset = make_dataset(cfg.data)

    def labels(n, seed):
        return (None if dataset is None
                else dataset.random_labels(n, seed=seed))

    def map_z(z, label):
        n = z.shape[0]
        lab = None if label is None else _pad_rows(
            np.array(label, np.float32), bs)
        return progs.map_z(_pad_rows(np.array(z, np.float32), bs), lab), n

    def synth(ws, n, psi, noise_tag):
        out = progs.synthesize(ws, np.full((bs,), psi, np.float32),
                               seed=noise_seed_of(args.seed, noise_tag))
        return out[:n].float().cpu().numpy()

    def sample_batch(z, noise_tag, label=None):
        ws, n = map_z(z, label)
        return synth(ws, n, args.truncation_psi, noise_tag)

    out_dir = args.out or os.path.join(run_dir, "generated")
    os.makedirs(out_dir, exist_ok=True)
    written = []
    all_imgs = []
    for i in range(0, args.images_num, bs):
        n = min(bs, args.images_num - i)
        all_imgs.append(sample_batch(draw_z(args.seed, i, n, m), i + 1,
                                     labels(n, args.seed + i)))
    imgs = np.concatenate(all_imgs)

    if args.save_attention:
        n = min(bs, args.images_num)
        label = labels(n, args.seed)
        att_imgs, probs = attention_maps(
            bundle, draw_z(args.seed, 0, n, m), args.truncation_psi,
            args.seed, None if label is None else torch.from_numpy(
                np.asarray(label, np.float32)))
        path = os.path.join(out_dir, "attn.png")
        save_attention_grid(att_imgs, probs, path)
        written.append(path)

    if args.interpolate:
        rows, steps = args.interpolate
        if rows > bs:
            raise SystemExit(f"--interpolate ROWS ({rows}) must be "
                             f"<= --batch-size ({bs})")
        za, zb = draw_z(args.seed, 101, rows, m), draw_z(args.seed, 202,
                                                          rows, m)
        label = labels(rows, args.seed + 7)
        strip = []
        for s in range(steps):     # the frames share their noise
            t = s / max(steps - 1, 1)
            zt = ((1.0 - t) * za + t * zb).astype(np.float32)
            strip.append(sample_batch(zt, 303, label))
        inter = np.stack(strip, axis=1).reshape(rows * steps,
                                                *strip[0].shape[1:])
        path = os.path.join(out_dir, "interp.png")
        save_image_grid(inter, path, grid=(steps, rows))
        written.append(path)

    if args.style_mix:
        rows, cols = args.style_mix

        def map_ws(tag, n, label_seed):
            ws, n = map_z(draw_z(args.seed, tag, n, m),
                          labels(n, label_seed))
            return apply_truncation(ws, bundle.w_avg,
                                    args.truncation_psi)[:n]

        ws_a = map_ws(404, rows, args.seed + 11)
        ws_b = map_ws(505, cols, args.seed + 12)
        cross = max(1, m.components // 2)
        mix = ws_b[None].expand((rows,) + tuple(ws_b.shape)).clone()
        mix[:, :, :cross] = ws_a[:, None, :cross]
        flat = mix.reshape((-1,) + tuple(mix.shape[2:]))
        mixed = []
        for i in range(0, flat.shape[0], bs):
            chunk = flat[i:i + bs]
            n = chunk.shape[0]
            padded = torch.cat([chunk, chunk[-1:].expand(
                (bs - n,) + tuple(chunk.shape[1:]))]) if n < bs else chunk
            mixed.append(synth(padded, n, 1.0, 606))   # truncated above
        path = os.path.join(out_dir, "mix.png")
        save_image_grid(np.concatenate(mixed), path, grid=(cols, rows))
        written.append(path)

    if args.grid:
        path = os.path.join(out_dir, "grid.png")
        save_image_grid(imgs, path)
        written.append(path)
    else:
        for i, im in enumerate(to_uint8(imgs)):
            with open(os.path.join(out_dir, f"img{i:04d}.png"), "wb") as f:
                f.write(png_bytes(im))
        written.append(f"{len(imgs)} images -> {out_dir}")
    for w in written:
        print(w)
    print(json.dumps({"run_dir": run_dir, "device": str(bundle.device),
                      "images": int(len(imgs))}))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in LATER_FLAGS:
            raise SystemExit(f"{flag}: not in the PyTorch port; it "
                             f"{LATER_FLAGS[flag]}")
    p = argparse.ArgumentParser(
        description="Sample images from a run, or a grid from seeds "
                    "(PyTorch port)")
    p.add_argument("--run-dir", default=None,
                   help="run dir with checkpoints/ + config.json (the "
                        "port's or the JAX package's), or a packed run "
                        "archive (.tar.gz from pack_run)")
    p.add_argument("--out", default=None,
                   help="output dir (default <run>/generated); with "
                        "--seeds the grid's path (default grid.png)")
    p.add_argument("--images-num", type=int, default=32)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--truncation-psi", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--grid", action="store_true",
                   help="one grid PNG instead of singles")
    p.add_argument("--save-attention", action="store_true",
                   help="also save latent->region attention overlays "
                        "(attn.png; needs an attention model and --device "
                        "cpu: the maps come from the plain path, the "
                        "kernels never write the probabilities)")
    p.add_argument("--interpolate", type=int, nargs=2, default=None,
                   metavar=("ROWS", "STEPS"),
                   help="also save latent-interpolation strips: ROWS pairs "
                        "of endpoints, STEPS z-lerp columns (interp.png)")
    p.add_argument("--style-mix", type=int, nargs=2, default=None,
                   metavar=("ROWS", "COLS"),
                   help="also save the component-mixing grid: row sources "
                        "keep the leading latent components, column "
                        "sources supply the suffix (mix.png)")
    p.add_argument("--preset", default="ffhq256-duplex",
                   help="without --run-dir: the model to sample from "
                        "random weights or --params-npz")
    p.add_argument("--config", default=None,
                   help="without --run-dir: a JAX run's config.json (its "
                        "model section wins over --preset)")
    p.add_argument("--params-npz", default=None)
    p.add_argument("--seeds", default="0-7",
                   help="without --run-dir: one latent per seed, one grid")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.run_dir:
        return _run_main(args)
    return _seeds_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
