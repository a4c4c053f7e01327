"""Training data of the port: the readers of ``gansformer_tpu/data/dataset.py``
(numpy and the standard library; a copy, not an import) and the uint8 ->
[-1, 1] normalization on the card.

Every source's ``batches(batch_size, seed, shard, start_batch)`` yields
``{"image": uint8 [N, H, W, C]}`` (plus ``"label"`` where the data has
labels) with the JAX package's index streams exactly, so both packages
read the same reals batch for batch, and ``start_batch`` positions the
stream at a resumed iteration by advancing the random stream only:

* ``SyntheticDataset``: procedural images, image i a function of i.
* ``NpzDataset``: a packed ``images`` (+ ``labels``) archive.
* ``TFRecordDataset``: the reference's multi-resolution records, every
  file of the matched resolution, each with a record-offset index
  sidecar (``<file>.idx.npz``) so every record is addressable.  Corrupt
  records (bad payload CRC, malformed proto) are quarantined into
  ``data_quarantine.jsonl`` and their slot refilled from the next good
  record, until more than ``max_corrupt_frac`` are (``DataCorrupt``);
  transient reads retry under bounded backoff.  The CRCs, the frame scan
  and the Example walk run in the port's native host ops
  (``gansformer_tpu_torch/native``), or in Python without them (no CRC
  check then).
* ``ImageFolderDataset``: images decoded with Pillow, which the card's
  machine lacks: there it raises, naming ``prepare_data``, the tool that
  turns a folder into TFRecords on a host.
* ``PrefetchIterator``: a producer thread with a bounded queue and the
  stall watchdog (``DataStalled``).
"""

from __future__ import annotations

import glob
import os
import queue
import re
import struct
import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gansformer_tpu_torch.core.precision import widen
from gansformer_tpu_torch.data.errors import DataCorrupt, stall_guarded_get
from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.supervise import faults


def normalize_images(uint8_images: torch.Tensor) -> torch.Tensor:
    """uint8 [N,H,W,C] -> float32 in [-1, 1], on the tensor's device."""
    return widen(uint8_images) / 127.5 - 1.0


class Dataset:
    """Iterator protocol: ``batches(batch_size)`` yields dicts with
    ``image`` [N,H,W,C] uint8 and optional ``label`` [N,label_dim] f32."""

    resolution: int
    channels: int
    has_labels: bool = False
    label_dim: int = 0
    num_images: Optional[int] = None

    def batches(self, batch_size: int, seed: int = 0,
                shard: Tuple[int, int] = (0, 1),
                start_batch: int = 0) -> Iterator[dict]:
        """Infinite batch stream.  ``start_batch`` positions the stream
        at batch index N of the seed-determined sequence — the resume
        contract: a run restored at iteration N consumes the same
        batches an uninterrupted run would, so loss trajectories stay
        tick-for-tick IDENTICAL across restarts.  Every source is
        index-addressed (the TFRecords through their record-offset
        sidecar), so the fast-forward advances the RNG stream only — no
        image decode."""
        raise NotImplementedError

    def set_quarantine_ledger(self, path: str) -> None:
        """Point the source's corruption-quarantine ledger at
        ``<run_dir>/data_quarantine.jsonl`` (the train loop wires this).
        Sources without a quarantine path (synthetic/npz/folder decode
        from trusted memory) ignore it."""

    def close(self) -> None:
        """Release OS resources (cached record fds).  Idempotent; a
        no-op for in-memory sources.  The train loop's finally calls
        it after the prefetch layers have joined."""

    def random_labels(self, n: int, seed: int = 0) -> Optional[np.ndarray]:
        """n labels drawn from the dataset's label distribution (reference
        ``get_random_labels``) — for conditional sampling at eval/snapshot
        time.  None for unconditional datasets."""
        labels = getattr(self, "labels", None)
        if labels is None:
            return None
        rs = np.random.RandomState(seed)
        return labels[rs.randint(0, len(labels), size=n)]


class SyntheticDataset(Dataset):
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

    def batches(self, batch_size, seed=0, shard=(0, 1), start_batch=0):
        rs = np.random.RandomState(seed)
        shard_id, num_shards = shard
        for _ in range(start_batch):   # advance the index stream only
            rs.randint(0, self.num_images, size=batch_size)
        while True:
            idx = rs.randint(0, self.num_images, size=batch_size)
            idx = idx * num_shards + shard_id  # disjoint streams per host
            yield {"image": self._make(idx)}


class NpzDataset(Dataset):
    """Packed numpy archive: ``images`` [N,H,W,C] uint8 (+ optional
    ``labels``).  The fast path for small datasets (CIFAR/CLEVR-scale)."""

    def __init__(self, path: str):
        self.path = path
        with np.load(path) as z:
            self.images = z["images"]
            self.labels = z["labels"].astype(np.float32) if "labels" in z else None
        assert self.images.dtype == np.uint8 and self.images.ndim == 4
        self.resolution = self.images.shape[1]
        self.channels = self.images.shape[3]
        self.num_images = len(self.images)
        self.has_labels = self.labels is not None
        self.label_dim = 0 if self.labels is None else self.labels.shape[1]

    def batches(self, batch_size, seed=0, shard=(0, 1), start_batch=0):
        rs = np.random.RandomState(seed)
        shard_id, num_shards = shard
        local = np.arange(shard_id, self.num_images, num_shards)
        for _ in range(start_batch):   # advance the index stream only
            rs.randint(0, len(local), size=batch_size)
        while True:
            idx = local[rs.randint(0, len(local), size=batch_size)]
            out = {"image": self.images[idx]}
            if self.labels is not None:
                out["label"] = self.labels[idx]
            yield out


_SCAN_CHUNK = 64 * 1024 * 1024


def _file_sig(path: str) -> Tuple[int, int]:
    st = os.stat(path)
    return int(st.st_mtime_ns), int(st.st_size)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _walk_proto(buf: bytes):
    """Yield (field_number, wire_type, value) for one protobuf message.
    value is bytes for length-delimited fields, int for varint."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:        # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 2:      # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt in (1, 5):  # fixed64 / fixed32
            n = 8 if wt == 1 else 4
            if pos + n > end:   # a ValueError, as the native walk raises
                raise ValueError("truncated fixed-width field")
            val = struct.unpack("<Q" if wt == 1 else "<I",
                                buf[pos:pos + n])[0]
            pos += n
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_example_image(payload: bytes) -> np.ndarray:
    """The reference's ``tf.train.Example`` {shape: int64[3], data: bytes}
    -> HWC uint8: the native walk (zero-copy ``np.frombuffer`` view) or
    the Python walk below.

    Schema (tensorflow/core/example/example.proto): Example.features(1)
    -> Features.feature(1) map<string, Feature> -> MapEntry{key(1),
    value(2)} -> Feature{bytes_list(1)|int64_list(3)} ->
    {BytesList,Int64List}.value(1).  Raises on a malformed record, which
    the TFRecord source quarantines."""
    from gansformer_tpu_torch import native

    parsed = native.parse_example(payload) if native.get_lib() else None
    if parsed is not None:
        shape, d_off, d_len = parsed
        arr = np.frombuffer(payload, np.uint8, count=d_len,
                            offset=d_off).reshape(shape)
        if arr.ndim == 3 and arr.shape[0] in (1, 3) and \
                arr.shape[0] < arr.shape[2]:
            arr = arr.transpose(1, 2, 0)  # CHW (reference layout) → HWC
        return arr

    features = None
    for field, _, val in _walk_proto(payload):
        if field == 1:                      # Example.features
            features = val
    if features is None:
        raise ValueError("record has no Features message")

    shape = None
    data = None
    for field, _, entry in _walk_proto(features):
        if field != 1:                      # Features.feature map entries
            continue
        key = None
        feat = None
        for f2, _, v2 in _walk_proto(entry):
            if f2 == 1:
                key = v2.decode()
            elif f2 == 2:
                feat = v2
        if key == "shape" and feat is not None:
            for f3, _, v3 in _walk_proto(feat):
                if f3 == 3:                 # Feature.int64_list
                    vals = []
                    for f4, wt4, v4 in _walk_proto(v3):
                        if f4 == 1 and wt4 == 0:
                            vals.append(v4)
                        elif f4 == 1 and wt4 == 2:   # packed
                            p = 0
                            while p < len(v4):
                                x, p = _read_varint(v4, p)
                                vals.append(x)
                    shape = vals
        elif key == "data" and feat is not None:
            for f3, _, v3 in _walk_proto(feat):
                if f3 == 1:                 # Feature.bytes_list
                    for f4, _, v4 in _walk_proto(v3):
                        if f4 == 1:
                            data = v4
    if shape is None or data is None:
        raise ValueError("record missing 'shape' or 'data' feature")
    arr = np.frombuffer(data, np.uint8).reshape(shape)
    if arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[0] < arr.shape[2]:
        arr = arr.transpose(1, 2, 0)  # CHW (reference layout) → HWC
    return arr


# --- record-offset index ------------------------------------------------------

_INDEX_VERSION = 1


def _index_path(path: str) -> str:
    return path + ".idx.npz"


def _py_scan_frames(buf: bytes):
    """Python framing fallback: (payload offsets, lengths, consumed) for
    every COMPLETE record frame in ``buf`` — lengths trusted (no CRC),
    mirroring the pre-index Python read path."""
    offs: List[int] = []
    lens: List[int] = []
    pos = 0
    n = len(buf)
    while pos + 12 <= n:
        (length,) = struct.unpack("<Q", buf[pos:pos + 8])
        end = pos + 12 + length + 4
        if length > 2**30 or end > n:
            break                      # partial tail or hostile length
        offs.append(pos + 12)
        lens.append(length)
        pos = end
    return offs, lens, pos


def build_record_index(path: str) -> dict:
    """One streaming pass over a TFRecord file → the offset index:
    ``offsets``/``lengths`` (np.int64, absolute payload spans) of every
    record whose framing — and, with the native lib, payload CRC —
    verifies, plus ``bad`` [(offset, length, cause)] for records
    quarantined at scan time.  A tail whose framing cannot be walked
    (torn file, corrupt length field) becomes ONE ``unframeable-tail``
    entry covering the rest of the file — the scanner cannot resync
    past a broken frame, but everything before it stays readable."""
    from gansformer_tpu_torch import native
    from gansformer_tpu_torch.data.tfrecord_writer import _masked_crc

    lib = native.get_lib()
    size = os.path.getsize(path)
    offsets: List[int] = []
    lengths: List[int] = []
    bad: List[Tuple[int, int, str]] = []
    base = 0                       # file offset of buf[0]
    leftover = b""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_SCAN_CHUNK)
            buf = leftover + chunk
            if not buf:
                break
            if lib is not None:
                offs, lens, consumed = native.scan_records(
                    buf, verify_crc=False)
            else:
                offs, lens, consumed = _py_scan_frames(buf)
            for o, ln in zip(offs, lens):
                o, ln = int(o), int(ln)
                if lib is not None:
                    (want,) = struct.unpack("<I", buf[o + ln:o + ln + 4])
                    if _masked_crc(buf[o:o + ln]) != want:
                        bad.append((base + o, ln, "payload-crc"))
                        continue
                offsets.append(base + o)
                lengths.append(ln)
            leftover = buf[consumed:]
            base += consumed
            if not chunk:              # EOF
                if leftover:
                    bad.append((base, len(leftover), "unframeable-tail"))
                break
            if consumed == 0 and len(buf) > 2**30:
                # a corrupt length field claims a multi-GB record: stop
                # scanning, quarantine the rest of the file as one span
                bad.append((base, size - base, "unframeable-tail"))
                break
    return {"offsets": np.asarray(offsets, np.int64),
            "lengths": np.asarray(lengths, np.int64),
            "bad": bad}


def load_record_index(path: str) -> dict:
    """The file's record-offset index — from the ``<file>.idx.npz``
    sidecar when it matches the file's (mtime_ns, size) signature, else
    rebuilt by one scan pass and persisted (best-effort: a read-only
    dataset dir keeps the index in memory for the process)."""
    mtime_ns, size = _file_sig(path)
    sidecar = _index_path(path)
    if os.path.exists(sidecar):
        try:
            with np.load(sidecar, allow_pickle=False) as z:
                if (int(z["version"]) == _INDEX_VERSION
                        and int(z["mtime_ns"]) == mtime_ns
                        and int(z["size"]) == size):
                    return {
                        "offsets": z["offsets"].astype(np.int64),
                        "lengths": z["lengths"].astype(np.int64),
                        "bad": [(int(o), int(ln), str(c)) for o, ln, c in
                                zip(z["bad_offsets"], z["bad_lengths"],
                                    z["bad_causes"])]}
        except (OSError, ValueError, KeyError):
            pass                       # torn/stale sidecar: rebuild
    idx = build_record_index(path)
    try:
        tmp = f"{sidecar}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(
                f, version=np.int64(_INDEX_VERSION),
                mtime_ns=np.int64(mtime_ns), size=np.int64(size),
                offsets=idx["offsets"], lengths=idx["lengths"],
                bad_offsets=np.asarray([b[0] for b in idx["bad"]], np.int64),
                bad_lengths=np.asarray([b[1] for b in idx["bad"]], np.int64),
                bad_causes=np.asarray([b[2] for b in idx["bad"]], np.str_))
        os.replace(tmp, sidecar)
    except OSError:
        pass                           # unwritable dataset dir: in-memory
    return idx


def _lod_of(fname: str) -> int:
    m = re.findall(r"-r(\d+)", os.path.basename(fname))
    return int(m[-1]) if m else -1


class TFRecordDataset(Dataset):
    """Index-addressed reader of the reference's multi-resolution TFRecord
    layout: ``<dir>/<name>-r{02..10}.tfrecords`` + optional ``*.labels``.
    ALL files matching the selected resolution are read (a sharded
    dataset's shards are one logical source); each file
    carries a record-offset index sidecar (``<file>.idx.npz``) built on
    first pass, so every record is addressable by (file, offset, length):

    * ``batches(start_batch=N)`` fast-forwards by advancing the RNG
      stream only — kill→resume runs are tick-for-tick loss-identical
      (the resume-exact contract).
    * Shuffling is per-epoch permutation of the shard-local good-record
      set (every record exactly once per epoch, like the reference's
      epoch-wide shuffle; ``shuffle_buffer`` is accepted for API compat
      but the index makes the decoded-window reservoir unnecessary).
    * Corrupt records (bad payload CRC at index build, malformed proto
      at decode) are QUARANTINED — offset+cause appended to the
      ``data_quarantine.jsonl`` ledger, ``data/corrupt_records_total``
      incremented, the batch slot deterministically re-filled from the
      next good record — and the run only fails typed (``DataCorrupt``)
      once quarantined/total exceeds ``max_corrupt_frac``.
    * Transient read errors retry under bounded exponential backoff
      (``io_retries`` × ``io_retry_base_s``, ``data/read_retries_total``).

    Fault points (supervise/faults.py): ``data_read_error`` /
    ``data_slow_read`` fire before every record read (coordinate ``n`` =
    monotonic read count), ``data_corrupt_record`` before every proto
    parse (coordinate ``n`` = monotonic parse count).
    """

    def __init__(self, path: str, resolution: Optional[int] = None,
                 shuffle_buffer: int = 4096,
                 max_corrupt_frac: float = 0.01,
                 io_retries: int = 3,
                 io_retry_base_s: float = 0.05):
        self.path = path
        files = sorted(glob.glob(os.path.join(path, "*.tfrecords")))
        if not files:
            raise FileNotFoundError(f"no .tfrecords under {path}")
        match = []
        if resolution is not None:
            lod = int(np.log2(resolution))
            match = [f for f in files
                     if f"-r{lod:02d}" in os.path.basename(f)]
        if not match:
            # No (or no matching) lod tag: fall back to the highest
            # single-resolution group — the pre-index reader's
            # files[-1] behavior, but never a MIX of lods, which the
            # shape check would read as mass corruption against the
            # probed resolution (spurious DataCorrupt).
            top = max(_lod_of(f) for f in files)
            match = [f for f in files if _lod_of(f) == top]
        files = match
        self.files = files
        self.shuffle_buffer = shuffle_buffer
        self.max_corrupt_frac = float(max_corrupt_frac)
        self.io_retries = int(io_retries)
        self.io_retry_base_s = float(io_retry_base_s)

        self._c_corrupt = telemetry.counter("data/corrupt_records_total")
        self._c_retries = telemetry.counter("data/read_retries_total")
        self._g_frac = telemetry.gauge("data/corrupt_frac")
        self._ledger_path: Optional[str] = None
        self._pending_ledger: List[dict] = []
        self._bad_seen: set = set()     # {(file_idx, offset)}
        self._fds: dict = {}
        self._reads = 0
        self._parses = 0

        # Per-file indexes → one flat addressable record table.  A good
        # record's ORIGINAL position (its rank among good+bad records in
        # file order) indexes the label array — labels stay aligned even
        # when earlier records are quarantined.
        rec_file: List[np.ndarray] = []
        rec_off: List[np.ndarray] = []
        rec_len: List[np.ndarray] = []
        rec_orig: List[np.ndarray] = []
        total_scanned = 0
        for fi, fn in enumerate(self.files):
            idx = load_record_index(fn)
            offs, lens, bad = idx["offsets"], idx["lengths"], idx["bad"]
            all_offs = np.sort(np.concatenate(
                [offs, np.asarray([b[0] for b in bad], np.int64)]))
            rec_file.append(np.full(len(offs), fi, np.int32))
            rec_off.append(offs)
            rec_len.append(lens)
            rec_orig.append(total_scanned
                            + np.searchsorted(all_offs, offs))
            total_scanned += len(offs) + len(bad)
            for off, ln, cause in bad:
                self._note_bad(fi, int(off), int(ln), cause, check=False)
        self._rec_file = np.concatenate(rec_file)
        self._rec_off = np.concatenate(rec_off)
        self._rec_len = np.concatenate(rec_len)
        self._rec_orig = np.concatenate(rec_orig)
        self._total_scanned = total_scanned
        self.num_images = len(self._rec_off)
        if self.num_images == 0:
            raise DataCorrupt(
                f"no readable records under {path} "
                f"({len(self._bad_seen)} quarantined)")
        self._check_budget()

        first = self._read_parse(0)[1]
        self.resolution = first.shape[0]
        self.channels = first.shape[2]

        label_files = glob.glob(os.path.join(path, "*.labels"))
        self.labels = None
        if label_files:
            self.labels = np.load(label_files[0]).astype(np.float32)
            if len(self.labels) != total_scanned:
                raise ValueError(
                    f"label file {label_files[0]} has {len(self.labels)} "
                    f"rows but the matched record set "
                    f"({len(self.files)} file(s)) holds {total_scanned} "
                    f"records — labels would silently mis-align; "
                    f"regenerate the labels beside the shards")
            self.has_labels = True
            self.label_dim = self.labels.shape[1]

    # -- quarantine ----------------------------------------------------------

    def set_quarantine_ledger(self, path: str) -> None:
        self._ledger_path = path
        pending, self._pending_ledger = self._pending_ledger, []
        for rec in pending:
            self._ledger_append(rec)

    def _ledger_append(self, rec: dict) -> None:
        if self._ledger_path is None:
            self._pending_ledger.append(rec)
            return
        import json

        with open(self._ledger_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _note_bad(self, fi: int, off: int, ln: int, cause: str,
                  check: bool = True) -> None:
        key = (fi, off)
        if key in self._bad_seen:
            return
        self._bad_seen.add(key)
        self._c_corrupt.inc()
        self._ledger_append({
            "file": self.files[fi], "offset": off, "length": ln,
            "cause": cause, "time": time.time(), "pid": os.getpid()})
        if check:
            self._g_frac.set(len(self._bad_seen)
                             / max(self._total_scanned, 1))
            self._check_budget()

    def _check_budget(self) -> None:
        frac = len(self._bad_seen) / max(self._total_scanned, 1)
        self._g_frac.set(frac)
        if frac > self.max_corrupt_frac:
            raise DataCorrupt(
                f"{len(self._bad_seen)}/{self._total_scanned} records "
                f"quarantined ({frac:.1%}) exceeds max_corrupt_frac="
                f"{self.max_corrupt_frac:g} under {self.path} — a static "
                f"data defect; see the data_quarantine.jsonl ledger "
                f"(restarting cannot fix this)")

    # -- record IO -----------------------------------------------------------

    def close(self) -> None:
        """Close every cached record fd (idempotent — raw fds are not
        reclaimed by GC, so a process churning dataset instances would
        otherwise leak one per shard per instance)."""
        fds, self._fds = self._fds, {}
        for fd in fds.values():
            try:
                os.close(fd)
            except OSError:
                pass

    def _fd(self, fi: int) -> int:
        fd = self._fds.get(fi)
        if fd is None:
            fd = os.open(self.files[fi], os.O_RDONLY)
            self._fds[fi] = fd
        return fd

    def _read_record(self, pos: int) -> bytes:
        """Payload bytes of good-record ``pos``, retrying transient IO
        errors under bounded exponential backoff (``os.pread`` — no seek
        state, safe across generator instances)."""
        fi = int(self._rec_file[pos])
        off = int(self._rec_off[pos])
        ln = int(self._rec_len[pos])
        attempt = 0
        while True:
            self._reads += 1
            try:
                faults.fire("data_slow_read", n=self._reads)
                faults.fire("data_read_error", n=self._reads)
                data = os.pread(self._fd(fi), ln, off)
                if len(data) != ln:
                    # truncated-since-index: corruption, not a transient
                    raise ValueError(
                        f"short read ({len(data)}/{ln} bytes) at "
                        f"{self.files[fi]}:{off}")
                return data
            except (OSError, faults.FaultInjected) as e:
                old = self._fds.pop(fi, None)
                if old is not None:
                    try:
                        os.close(old)
                    except OSError:
                        pass
                attempt += 1
                if attempt > self.io_retries:
                    raise OSError(
                        f"read of {self.files[fi]}@{off} failed after "
                        f"{attempt} attempt(s): {e}") from e
                self._c_retries.inc()
                time.sleep(self.io_retry_base_s * (2 ** (attempt - 1)))

    def _read_parse(self, pos: int) -> Tuple[int, np.ndarray]:
        """Decode good-record ``pos`` — on a corrupt record, quarantine
        it and deterministically substitute the next good record (the
        same corrupt bytes map to the same substitute on every run, so
        the stream stays resume-exact on a static defect)."""
        for probe in range(self.num_images):
            p = (pos + probe) % self.num_images
            fi = int(self._rec_file[p])
            try:
                payload = self._read_record(p)
                self._parses += 1
                faults.fire("data_corrupt_record", n=self._parses)
                arr = _parse_example_image(payload)
                if getattr(self, "resolution", None) and arr.shape != (
                        self.resolution, self.resolution, self.channels):
                    raise ValueError(f"record shape {arr.shape} != dataset "
                                     f"{(self.resolution, self.resolution, self.channels)}")
                return p, arr
            except (ValueError, IndexError, UnicodeDecodeError,
                    faults.FaultInjected) as e:
                self._note_bad(fi, int(self._rec_off[p]),
                               int(self._rec_len[p]),
                               f"{type(e).__name__}: {str(e)[:200]}")
        raise DataCorrupt(f"no readable record left under {self.path}")

    # -- stream --------------------------------------------------------------

    def batches(self, batch_size, seed=0, shard=(0, 1), start_batch=0):
        rs = np.random.RandomState(seed)
        shard_id, num_shards = shard
        local = np.arange(shard_id, self.num_images, num_shards)
        n = len(local)
        if n < batch_size:
            raise ValueError(
                f"shard {shard_id}/{num_shards} holds {n} record(s) < "
                f"batch_size {batch_size}")
        per_epoch = n // batch_size
        # Seekable fast-forward: whole epochs advance the permutation
        # stream only (one rs.permutation call each — no decode), which
        # is what makes kill→resume tick-parity exact on TFRecords.
        epochs, r = divmod(start_batch, per_epoch)
        for _ in range(epochs):
            rs.permutation(n)
        perm = rs.permutation(n)
        pos = r * batch_size
        while True:
            if pos + batch_size > per_epoch * batch_size:
                perm = rs.permutation(n)
                pos = 0
            idx = local[perm[pos:pos + batch_size]]
            pos += batch_size
            yield self._emit(idx)

    def _emit(self, idx: Sequence[int]) -> dict:
        imgs = []
        orig = []
        for i in idx:
            p, arr = self._read_parse(int(i))
            imgs.append(arr)
            orig.append(int(self._rec_orig[p]))
        out = {"image": np.stack(imgs)}
        if self.labels is not None:
            out["label"] = self.labels[np.asarray(orig)]
        return out


class ImageFolderDataset(Dataset):
    """Directory of PNG/JPG images, centre-cropped and resized to a
    power-of-2 resolution on the fly, decoded with Pillow.  Where Pillow
    is missing (the card's machine) the first decode raises, naming
    ``prepare_data``: convert the folder to TFRecords on a host that has
    it.  There is no other source to fall back to."""

    def __init__(self, path: str, resolution: int):
        self.path = path
        exts = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
        self.files = sorted(
            os.path.join(r, fn)
            for r, _, fns in os.walk(path)
            for fn in fns if fn.lower().endswith(exts))
        if not self.files:
            raise FileNotFoundError(f"no images under {path}")
        self.resolution = resolution
        self.channels = 3
        self.num_images = len(self.files)

    def _load(self, fn: str) -> np.ndarray:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                f"data source 'folder' ({self.path}) decodes images with "
                f"Pillow, which this machine lacks; convert the folder to "
                f"TFRecords with prepare_data on a host that has Pillow "
                f"(prepare_data --source-dir {self.path} --to tfrecord "
                f"--out <dir>) and train with --data-source tfrecord"
                ) from e
        img = Image.open(fn).convert("RGB")
        s = min(img.size)
        left = (img.size[0] - s) // 2
        top = (img.size[1] - s) // 2
        img = img.crop((left, top, left + s, top + s))
        img = img.resize((self.resolution, self.resolution), Image.LANCZOS)
        return np.asarray(img, dtype=np.uint8)

    def batches(self, batch_size, seed=0, shard=(0, 1), start_batch=0):
        rs = np.random.RandomState(seed)
        shard_id, num_shards = shard
        local = np.arange(shard_id, len(self.files), num_shards)
        for _ in range(start_batch):   # advance the index stream only
            rs.randint(0, len(local), size=batch_size)
        while True:
            idx = local[rs.randint(0, len(local), size=batch_size)]
            yield {"image": np.stack([self._load(self.files[i])
                                      for i in idx])}


class PrefetchIterator:
    """Background-thread prefetch with a bounded queue — overlaps host-side
    decode/shuffle with device compute (the tf.data ``prefetch`` analog the
    reference gets for free from its in-graph input pipeline).

    Exceptions raised by the producer surface on the consumer's next
    ``next()``; ``close()`` (also via context manager) stops the thread.

    Stall watchdog: with ``stall_after_s > 0``, a consumer
    blocked on an empty queue while the producer makes NO progress for
    that long raises typed ``DataStalled`` — a classified, fast data-hang
    signal (wedged NFS read, hung decode) instead of waiting for the
    supervisor's generic heartbeat-staleness SIGKILL.  Progress = items
    landing in the queue, so ``stall_after_s`` must exceed the worst-case
    single-batch decode time.

    Telemetry (obs/registry): ``data/prefetch_queue_depth`` gauge (ready
    batches waiting), ``data/starved_total`` counter (consumer arrived
    to an empty queue — the producer is the bottleneck), ``data/wait_ms``
    histogram (per-``next()`` block time), ``data/batches_total``,
    ``data/stalls_total`` (watchdog verdicts).
    """

    _SENTINEL = object()

    def __init__(self, iterator: Iterator[dict], depth: int = 2,
                 stall_after_s: float = 0.0):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._finished = False
        self._error: Optional[BaseException] = None
        self._stall_after_s = float(stall_after_s or 0.0)
        self._last_progress = time.monotonic()
        self._g_depth = telemetry.gauge("data/prefetch_queue_depth")
        self._c_starved = telemetry.counter("data/starved_total")
        self._c_batches = telemetry.counter("data/batches_total")
        self._c_stalls = telemetry.counter("data/stalls_total")
        self._h_wait_ms = telemetry.histogram("data/wait_ms")

        def _produce():
            try:
                for n, item in enumerate(iterator):
                    # Fault-injection point: a 'hang' armed here models
                    # the wedged data thread — with the watchdog armed
                    # the consumer raises DataStalled; without it the
                    # loop blocks in data_wait until the supervisor's
                    # staleness probe ends the run.
                    faults.fire("data_thread", batch=n)
                    while not self._stop.is_set():
                        try:
                            self._queue.put(item, timeout=0.1)
                            self._last_progress = time.monotonic()
                            self._g_depth.set(self._queue.qsize())
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — reraised on consumer
                self._error = e
            finally:
                while not self._stop.is_set():
                    try:
                        self._queue.put(self._SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=_produce, daemon=True)
        self._thread.start()

    def _pop(self):
        """Blocking pop under the shared stall-watchdog conviction rule
        (``errors.stall_guarded_get`` — one algorithm for both prefetch
        layers)."""
        return stall_guarded_get(
            self._queue, self._stall_after_s,
            lambda: self._last_progress, self._c_stalls,
            "data producer")

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._finished or self._stop.is_set():
            raise StopIteration
        starved = self._queue.empty()
        t0 = time.perf_counter()
        item = self._pop()
        if item is self._SENTINEL:
            # end-of-stream teardown wait is not data starvation — don't
            # let it skew the input-bound diagnosis counters
            self._finished = True
            if self._error is not None:
                raise self._error
            raise StopIteration
        if starved:                  # device-side starvation: input-bound
            self._c_starved.inc()
        self._h_wait_ms.observe((time.perf_counter() - t0) * 1000.0)
        self._g_depth.set(self._queue.qsize())
        self._c_batches.inc()
        return item

    def close(self) -> None:
        """Stop and join the producer thread.  Idempotent — the loop's
        ``finally`` and a context-manager exit may both call it.  After
        the join a sentinel is parked in the queue so any *consumer*
        blocked in ``__next__`` (a transfer thread pulling from this
        iterator) wakes with StopIteration
        instead of hanging on a drained queue."""
        self._stop.set()
        try:  # unblock a producer stuck on a full queue
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        try:   # wake consumers blocked on the (now idle) queue
            self._queue.put_nowait(self._SENTINEL)
        except queue.Full:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_dataset(cfg) -> Dataset:
    """cfg: DataConfig (core.config)."""
    if cfg.source == "synthetic":
        return SyntheticDataset(resolution=cfg.resolution, channels=cfg.channels)
    if cfg.source == "npz":
        return NpzDataset(cfg.path)
    if cfg.source == "tfrecord":
        return TFRecordDataset(cfg.path, resolution=cfg.resolution,
                               shuffle_buffer=cfg.shuffle_buffer,
                               max_corrupt_frac=cfg.max_corrupt_frac,
                               io_retries=cfg.io_retries,
                               io_retry_base_s=cfg.io_retry_base_s)
    if cfg.source == "folder":
        return ImageFolderDataset(cfg.path, resolution=cfg.resolution)
    raise ValueError(f"unknown data source {cfg.source!r}")
