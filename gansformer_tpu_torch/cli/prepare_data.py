"""Prepare a training dataset with the PyTorch port: the JAX package's
``prepare_data`` (``gansformer_tpu/cli/prepare_data.py``), the role of the
reference's ``dataset_tool.py``.

    python -m gansformer_tpu_torch.cli.prepare_data --synthetic \\
        --resolution 256 --max-images 1000 --to tfrecord --out data/smoke

Sources: ``--synthetic`` (the procedural images of ``SyntheticDataset``),
``--cifar10-dir`` (an extracted cifar-10-batches-py directory; labels
kept), ``--lsun-lmdb-dir`` (needs the ``lmdb`` package and Pillow) and
``--source-dir`` (a directory of images, decoded with Pillow: on a host
without it, such as the card's machine, convert the folder on another
host).  Outputs: ``--to npz`` (uint8 NHWC ``images`` and optional
``labels``) or ``--to tfrecord`` (the reference's multi-resolution
``<name>-rNN.tfrecords``, ``--max-lod-only`` for the full resolution
alone).  The files are byte for byte the JAX CLI's.  ``--download`` and
its options need the network and are refused.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

# The JAX CLI's download flags: the port makes no network access.
NETWORK_FLAGS = ("--download", "--download-dir", "--mirror-url",
                 "--download-no-verify")


def refuse_network_flags(argv: List[str]) -> None:
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in NETWORK_FLAGS:
            raise SystemExit(
                f"{flag}: not in the PyTorch port; a download needs the "
                f"network.  Fetch the archive on a host that has it, "
                f"extract it, and pass --cifar10-dir, --lsun-lmdb-dir or "
                f"--source-dir")


def _collect(args):
    """The input source -> (image chunk iterator, labels or None)."""
    if args.synthetic:
        from gansformer_tpu_torch.data.dataset import SyntheticDataset

        n = args.max_images or 10000
        ds = SyntheticDataset(resolution=args.resolution, num_images=n)
        idx = np.arange(n)
        return (ds._make(idx[i:i + 64]) for i in range(0, n, 64)), None
    if args.cifar10_dir:
        from gansformer_tpu_torch.data.tfrecord_writer import load_cifar10

        images, labels = load_cifar10(args.cifar10_dir)
        if args.resolution != 32:
            raise SystemExit("CIFAR-10 is 32×32; pass --resolution 32")
        if args.max_images:
            images = images[:args.max_images]
            labels = labels[:args.max_images]
        return (images[i:i + 64] for i in range(0, len(images), 64)), labels
    if args.lsun_lmdb_dir:
        from gansformer_tpu_torch.data.tfrecord_writer import iter_lsun_lmdb

        def lsun_chunks():
            batch = []
            for img in iter_lsun_lmdb(args.lsun_lmdb_dir, args.resolution,
                                      args.max_images):
                batch.append(img)
                if len(batch) == 64:
                    yield np.stack(batch)
                    batch = []
            if batch:
                yield np.stack(batch)

        return lsun_chunks(), None
    if args.source_dir:
        from gansformer_tpu_torch.data.dataset import ImageFolderDataset

        ds = ImageFolderDataset(args.source_dir, resolution=args.resolution)
        files = ds.files[:args.max_images] if args.max_images else ds.files

        def folder_chunks():
            for i in range(0, len(files), 64):
                yield np.stack([ds._load(f) for f in files[i:i + 64]])

        return folder_chunks(), None
    return None, None


def main(argv: Optional[List[str]] = None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_network_flags(argv)
    p = argparse.ArgumentParser(
        description="Prepare a training dataset (PyTorch port)")
    p.add_argument("--source-dir", default=None,
                   help="directory of images (recursively scanned; decoded "
                        "with Pillow)")
    p.add_argument("--cifar10-dir", default=None,
                   help="extracted cifar-10-batches-py directory")
    p.add_argument("--lsun-lmdb-dir", default=None,
                   help="LSUN lmdb export directory (needs the lmdb pkg)")
    p.add_argument("--synthetic", action="store_true",
                   help="generate the procedural smoke dataset instead")
    p.add_argument("--to", choices=("npz", "tfrecord"), default="npz",
                   help="output format (tfrecord = reference layout)")
    p.add_argument("--out", required=True,
                   help=".npz path (--to npz) or output directory "
                        "(--to tfrecord)")
    p.add_argument("--name", default=None,
                   help="dataset name for tfrecord filenames "
                        "(default: basename of --out)")
    p.add_argument("--resolution", type=int, default=None,
                   help="output resolution (default 256; cifar10 pins 32)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--max-lod-only", action="store_true",
                   help="write only the full-resolution tfrecord file "
                        "(skip the progressive pyramid)")
    args = p.parse_args(argv)

    if args.resolution is None:
        args.resolution = 256
    chunks, labels = _collect(args)
    if chunks is None:
        p.error("need --source-dir, --cifar10-dir, --lsun-lmdb-dir or "
                "--synthetic")

    if args.to == "npz":
        imgs = np.concatenate(list(chunks))
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        if labels is not None:
            np.savez_compressed(args.out, images=imgs, labels=labels)
        else:
            np.savez_compressed(args.out, images=imgs)
        print(f"{len(imgs)} images @ {args.resolution}² → {args.out}")
        return 0

    from gansformer_tpu_torch.data.tfrecord_writer import TFRecordExporter

    name = args.name or os.path.basename(os.path.normpath(args.out))
    with TFRecordExporter(args.out, name, args.resolution,
                          all_lods=not args.max_lod_only) as ex:
        for chunk in chunks:
            for img in chunk:
                ex.add_image(img)
        if labels is not None:
            ex.add_labels(labels)
        n = ex.num_images
    print(f"{n} images @ {args.resolution}² → {args.out}/{name}-r*.tfrecords")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
