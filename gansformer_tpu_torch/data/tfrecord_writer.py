"""TFRecord writer (the port's copy of the framing, Example encoding and
``TFRecordExporter`` of ``gansformer_tpu/data/tfrecord_writer.py``).

It writes the reference's multi-resolution layout,
``<name>-r{02..10}.tfrecords``: one file per level of detail, each record
a ``tf.train.Example`` with ``shape`` (int64 [C,H,W]) and ``data`` (raw
CHW uint8), framed with masked CRC32C as stock ``tf.data`` reads it, and
optional ``<name>-rXX.labels`` (``np.save`` of float32).  The bytes are
the JAX writer's.  ``load_cifar10`` and ``iter_lsun_lmdb`` read the two
benchmark sources ``prepare_data`` converts (the roles of the
reference's ``dataset_tool`` ``create_cifar10`` and ``create_lsun``).  The CRC runs in the port's native host ops
(``gansformer_tpu_torch/native``) or, without them, in pure Python
(about 1 MB/s).  The TensorBoard writer reuses the framing.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Optional, Sequence

import numpy as np

# CRC32C (Castagnoli, reflected poly 0x82F63B78): the framing checksum.


def _make_crc_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


def crc32c_py(data: bytes) -> int:
    """Pure-Python CRC32C (a plain-list table)."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    from gansformer_tpu_torch import native

    val = native.crc32c(data)
    return crc32c_py(data) if val is None else val


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    rot = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rot + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------------------------
# Minimal protobuf encoding for tf.train.Example (inverse of the reader's
# _walk_proto in data/dataset.py).
# ----------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _int64_list_feature(values: Sequence[int]) -> bytes:
    body = b"".join(_varint(1 << 3 | 0) + _varint(v) for v in values)
    return _len_delim(3, body)            # Feature.int64_list = 3


def _bytes_feature(data: bytes) -> bytes:
    return _len_delim(1, _len_delim(1, data))   # Feature.bytes_list.value


def encode_example_image(img_chw: np.ndarray) -> bytes:
    """CHW uint8 image → serialized tf.train.Example (reference schema)."""
    assert img_chw.dtype == np.uint8 and img_chw.ndim == 3
    feats = b""
    for key, feat in (("shape", _int64_list_feature(img_chw.shape)),
                      ("data", _bytes_feature(img_chw.tobytes()))):
        entry = _len_delim(1, key.encode()) + _len_delim(2, feat)
        feats += _len_delim(1, entry)     # Features.feature map entry
    return _len_delim(1, feats)           # Example.features


def write_record(f, payload: bytes) -> None:
    """TFRecord framing: u64 len, u32 masked-crc(len), payload,
    u32 masked-crc(payload)."""
    head = struct.pack("<Q", len(payload))
    f.write(head)
    f.write(struct.pack("<I", _masked_crc(head)))
    f.write(payload)
    f.write(struct.pack("<I", _masked_crc(payload)))


# ----------------------------------------------------------------------------
# Multi-resolution exporter
# ----------------------------------------------------------------------------

def _downsample_box2(img: np.ndarray) -> np.ndarray:
    """HWC uint8 → half resolution by 2x2 box filter (dataset_tool's
    downscale)."""
    h, w, c = img.shape
    x = img.reshape(h // 2, 2, w // 2, 2, c).astype(np.uint16)
    return ((x.sum(axis=(1, 3)) + 2) // 4).astype(np.uint8)


class TFRecordExporter:
    """Streams HWC uint8 images into the reference's multi-lod layout.

    Usage::

        with TFRecordExporter(out_dir, name, resolution) as ex:
            for img in images:          # HWC uint8
                ex.add_image(img)
            ex.add_labels(labels)       # optional [N, label_dim]
    """

    def __init__(self, out_dir: str, name: str, resolution: int,
                 min_lod: int = 2, all_lods: bool = True):
        r_log2 = resolution.bit_length() - 1
        if resolution != 2 ** r_log2 or resolution < 4:
            raise ValueError(f"resolution must be a power of 2 ≥ 4, "
                             f"got {resolution}")
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir, self.name = out_dir, name
        self.resolution, self.max_lod = resolution, r_log2
        lods = (range(r_log2, min_lod - 1, -1) if all_lods else [r_log2])
        self._files = {
            lod: open(os.path.join(
                out_dir, f"{name}-r{lod:02d}.tfrecords"), "wb")
            for lod in lods}
        self.num_images = 0

    def add_image(self, img_hwc: np.ndarray) -> None:
        if img_hwc.shape[:2] != (self.resolution, self.resolution):
            raise ValueError(
                f"image is {img_hwc.shape}, expected {self.resolution}²")
        img = np.ascontiguousarray(img_hwc, dtype=np.uint8)
        for lod in sorted(self._files, reverse=True):
            while img.shape[0] > 2 ** lod:
                img = _downsample_box2(img)
            write_record(self._files[lod],
                         encode_example_image(img.transpose(2, 0, 1)))
        self.num_images += 1

    def add_labels(self, labels: np.ndarray) -> None:
        path = os.path.join(self.out_dir,
                            f"{self.name}-r{self.max_lod:02d}.labels")
        with open(path, "wb") as f:
            np.save(f, labels.astype(np.float32))

    def close(self) -> None:
        for f in self._files.values():
            f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def export_images(images: Iterable[np.ndarray], out_dir: str, name: str,
                  resolution: int, labels: Optional[np.ndarray] = None,
                  all_lods: bool = True) -> int:
    with TFRecordExporter(out_dir, name, resolution, all_lods=all_lods) as ex:
        for img in images:
            ex.add_image(img)
        if labels is not None:
            ex.add_labels(labels)
        return ex.num_images


# ----------------------------------------------------------------------------
# LSUN lmdb -> images; the dataset_tool ``create_lsun`` role.
# ----------------------------------------------------------------------------

def iter_lsun_lmdb(lmdb_dir: str, resolution: int,
                   max_images: Optional[int] = None):
    """Yields HWC uint8 images centre-cropped and resized to
    ``resolution`` from an LSUN lmdb export (webp/jpg values, keys
    ignored), as the JAX package's reader does.  It needs the ``lmdb``
    package and Pillow; without ``lmdb`` it raises the JAX reader's
    words.  Undecodable records are skipped with a count."""
    try:
        import lmdb  # type: ignore
    except ImportError as e:
        raise ImportError(
            "LSUN conversion needs the 'lmdb' package (pip install lmdb); "
            "it is not bundled because only the LSUN path uses it") from e
    import io

    from PIL import Image

    env = lmdb.open(lmdb_dir, readonly=True, lock=False, readahead=False,
                    meminit=False)
    n, bad = 0, 0
    with env.begin(write=False) as txn:
        for _key, val in txn.cursor():
            if max_images is not None and n >= max_images:
                break
            try:
                img = Image.open(io.BytesIO(val)).convert("RGB")
            except Exception:
                bad += 1
                continue
            s = min(img.size)
            left = (img.size[0] - s) // 2
            top = (img.size[1] - s) // 2
            img = img.crop((left, top, left + s, top + s))
            img = img.resize((resolution, resolution), Image.LANCZOS)
            yield np.asarray(img, dtype=np.uint8)
            n += 1
    if bad:
        import sys

        print(f"[prepare_data] skipped {bad} undecodable LSUN records",
              file=sys.stderr)


# ----------------------------------------------------------------------------
# CIFAR-10 (python pickle batches) -> arrays; the dataset_tool
# ``create_cifar10`` role.
# ----------------------------------------------------------------------------

def load_cifar10(data_dir: str):
    """The training batches (data_batch_1..5, those present) of an
    extracted cifar-10-batches-py directory: (images NHWC uint8, labels
    one-hot float32)."""
    import pickle

    imgs, labs = [], []
    names = [f"data_batch_{i}" for i in range(1, 6)]
    found = [n for n in names if os.path.exists(os.path.join(data_dir, n))]
    if not found:
        raise FileNotFoundError(
            f"no CIFAR-10 batches under {data_dir} (expected data_batch_1..5)")
    for n in found:
        with open(os.path.join(data_dir, n), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(np.asarray(d[b"data"], np.uint8)
                    .reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labs.extend(d[b"labels"])
    images = np.concatenate(imgs)
    labels = np.zeros((len(labs), 10), np.float32)
    labels[np.arange(len(labs)), np.asarray(labs)] = 1.0
    return images, labels
