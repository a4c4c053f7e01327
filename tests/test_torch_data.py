"""The port's data plane against the JAX package's: every source's batch
stream batch for batch at any ``start_batch`` (and shard), the TFRecord
writer byte for byte, the record index, the corrupt-record quarantine
and its budget, the retries and the stall watchdog, and the native host
ops against their pure-Python paths.  The TFRecords are written by
``gansformer_tpu/data/tfrecord_writer.py``."""

import json
import os

import numpy as np
import pytest
import torch

from gansformer_tpu.data import dataset as jds
from gansformer_tpu.data import tfrecord_writer as jwriter
from gansformer_tpu.data.errors import DataCorrupt as JaxDataCorrupt
from gansformer_tpu_torch import native
from gansformer_tpu_torch.data import dataset as pds
from gansformer_tpu_torch.data import tfrecord_writer as pwriter
from gansformer_tpu_torch.data.errors import DataCorrupt, DataStalled
from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.supervise import faults

RES = 16
N_IMAGES = 40


@pytest.fixture
def no_faults():
    faults.disarm()
    yield
    faults.disarm()


def _images(n=N_IMAGES, res=RES):
    return pds.SyntheticDataset(res, num_images=n)._make(np.arange(n))


def _id_imgs(ids, res=8):
    """Images whose pixel (0, 0, 0) names them."""
    out = []
    for i in ids:
        img = np.zeros((3, res, res), np.uint8)
        img[0, 0, 0] = i
        out.append(img)
    return out


def _write_toy(path, imgs):
    with open(path, "wb") as f:
        for img in imgs:
            jwriter.write_record(f, jwriter.encode_example_image(img))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """TFRecords (every level of detail) and labels written by the JAX
    writer."""
    d = str(tmp_path_factory.mktemp("tfrecords"))
    labels = np.eye(4, dtype=np.float32)[np.arange(N_IMAGES) % 4]
    jwriter.export_images(_images(), d, "toy", RES, labels=labels)
    return d


def _stream_equal(a, b, n=6):
    for _ in range(n):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def _tf_counter(name):
    return telemetry.counter(name).value


# --- batch streams, every source ---------------------------------------------

@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
@pytest.mark.parametrize("start", [0, 3, 11])
def test_synthetic_stream_matches_jax(start, shard):
    p, j = pds.SyntheticDataset(RES), jds.SyntheticDataset(RES)
    _stream_equal(p.batches(4, seed=5, shard=shard, start_batch=start),
                  j.batches(4, seed=5, shard=shard, start_batch=start), 3)


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
@pytest.mark.parametrize("start", [0, 3, 11])
def test_npz_stream_matches_jax(tmp_path, start, shard):
    path = str(tmp_path / "d.npz")
    np.savez(path, images=_images(),
             labels=np.eye(3, dtype=np.float32)[np.arange(N_IMAGES) % 3])
    p, j = pds.NpzDataset(path), jds.NpzDataset(path)
    assert (p.has_labels, p.label_dim) == (j.has_labels, j.label_dim)
    _stream_equal(p.batches(4, seed=2, shard=shard, start_batch=start),
                  j.batches(4, seed=2, shard=shard, start_batch=start))


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
@pytest.mark.parametrize("start", [0, 3, 9, 25])
def test_tfrecord_stream_matches_jax(records, start, shard):
    """Mid-epoch, at an epoch boundary (40 records, batch 4: 10 batches
    an epoch) and past it; labels aligned."""
    p = pds.TFRecordDataset(records, resolution=RES)
    j = jds.TFRecordDataset(records, resolution=RES)
    assert (p.num_images, p.resolution, p.channels, p.label_dim) == (
        j.num_images, j.resolution, j.channels, j.label_dim)
    _stream_equal(p.batches(4, seed=7, shard=shard, start_batch=start),
                  j.batches(4, seed=7, shard=shard, start_batch=start), 12)
    assert p.random_labels(5, seed=3).tolist() == \
        j.random_labels(5, seed=3).tolist()


@pytest.mark.parametrize("start", [0, 3])
def test_image_folder_stream_matches_jax(tmp_path, start):
    from PIL import Image

    for i, img in enumerate(_images(6, 24)):
        Image.fromarray(img).save(str(tmp_path / f"{i}.png"))
    p = pds.ImageFolderDataset(str(tmp_path), RES)
    j = jds.ImageFolderDataset(str(tmp_path), RES)
    _stream_equal(p.batches(2, seed=1, start_batch=start),
                  j.batches(2, seed=1, start_batch=start), 2)


def test_image_folder_without_pillow_names_prepare_data(tmp_path,
                                                        monkeypatch):
    import sys

    (tmp_path / "a.png").write_bytes(b"x")
    monkeypatch.setitem(sys.modules, "PIL", None)
    ds = pds.ImageFolderDataset(str(tmp_path), RES)
    with pytest.raises(ImportError, match="prepare_data"):
        next(ds.batches(1))


@pytest.mark.parametrize("source", ["synthetic", "npz", "tfrecord",
                                    "folder"])
def test_make_dataset_dispatches_as_jax(tmp_path, records, source):
    from gansformer_tpu.core.config import DataConfig as JaxData
    from gansformer_tpu_torch.core.config import DataConfig

    path = {"synthetic": None, "tfrecord": records}.get(source)
    if source == "npz":
        path = str(tmp_path / "d.npz")
        np.savez(path, images=_images(8))
    elif source == "folder":
        from PIL import Image

        path = str(tmp_path)
        Image.fromarray(_images(1)[0]).save(str(tmp_path / "a.png"))
    p = pds.make_dataset(DataConfig(source=source, path=path,
                                    resolution=RES))
    j = jds.make_dataset(JaxData(source=source, path=path, resolution=RES))
    assert type(p).__name__ == type(j).__name__
    assert p.num_images == j.num_images
    with pytest.raises(ValueError, match="unknown data source"):
        pds.make_dataset(DataConfig(source="bogus"))


def test_normalize_images_matches_jax():
    x = _images(2)
    np.testing.assert_allclose(
        pds.normalize_images(torch.from_numpy(x)).numpy(),
        np.asarray(jds.normalize_images(x)), rtol=0, atol=1e-7)


# --- the writer ----------------------------------------------------------------

@pytest.mark.parametrize("all_lods", [True, False])
def test_port_writer_is_byte_identical(tmp_path, all_lods):
    imgs = _images(12)
    labels = np.random.RandomState(0).rand(12, 5).astype(np.float32)
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jwriter.export_images(imgs, a, "x", RES, labels=labels,
                                 all_lods=all_lods) == 12
    assert pwriter.export_images(imgs, b, "x", RES, labels=labels,
                                 all_lods=all_lods) == 12
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def test_writer_crc_known_vectors_native_and_python():
    for data, want in ((b"", 0), (b"123456789", 0xE3069283),
                       (bytes(32), 0x8A9136AA)):
        assert pwriter.crc32c(data) == want
        assert pwriter.crc32c_py(data) == want
        assert jwriter.crc32c(data) == want


# --- the index, the parse, native vs Python ----------------------------------

def test_record_index_native_python_and_jax_agree(records, monkeypatch):
    path = os.path.join(records, f"toy-r{RES.bit_length() - 1:02d}"
                                 ".tfrecords")
    ours = pds.build_record_index(path)
    theirs = jds.build_record_index(path)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    plain = pds.build_record_index(path)
    for idx in (theirs, plain):
        np.testing.assert_array_equal(ours["offsets"], idx["offsets"])
        np.testing.assert_array_equal(ours["lengths"], idx["lengths"])
        assert ours["bad"] == idx["bad"] == []


def test_parse_example_native_matches_python(records, monkeypatch):
    assert native.get_lib() is not None
    path = os.path.join(records, "toy-r03.tfrecords")
    idx = pds.load_record_index(path)
    with open(path, "rb") as f:
        blob = f.read()
    payloads = [blob[o:o + n] for o, n in zip(idx["offsets"],
                                               idx["lengths"])]
    fast = [pds._parse_example_image(p) for p in payloads]
    monkeypatch.setattr(native, "get_lib", lambda: None)
    slow = [pds._parse_example_image(p) for p in payloads]
    for a, b in zip(fast, slow):
        np.testing.assert_array_equal(a, b)
    assert fast[0].shape == (8, 8, 3)
    with pytest.raises(ValueError):
        pds._parse_example_image(b"\x05not-a-proto")


def test_python_path_reads_the_same_stream(records, monkeypatch):
    fast = pds.TFRecordDataset(records, resolution=RES).batches(4, seed=3)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    slow = pds.TFRecordDataset(records, resolution=RES).batches(4, seed=3)
    _stream_equal(fast, slow, 4)


def test_sidecar_shared_with_jax(tmp_path):
    """The port reads the index sidecar the JAX reader wrote, and the
    other way round."""
    path = str(tmp_path / "toy-r03.tfrecords")
    _write_toy(path, _id_imgs(range(12)))
    jds.TFRecordDataset(str(tmp_path))
    assert os.path.exists(pds._index_path(path))
    built = []
    orig = pds.build_record_index
    pds.build_record_index = lambda p: built.append(p) or orig(p)
    try:
        assert pds.TFRecordDataset(str(tmp_path)).num_images == 12
    finally:
        pds.build_record_index = orig
    assert built == []


# --- quarantine, budget, retries, watchdog -----------------------------------

def _ledger_view(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(ln).items()
                 if k not in ("time", "pid")} for ln in f]


def test_garbage_proto_quarantine_matches_jax(tmp_path):
    """A framed record with a garbage proto: quarantined with the same
    ledger entry as JAX's, its slot refilled the same way, the stream
    equal to JAX's batch for batch."""
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        path = str(tmp_path / side / "toy-r03.tfrecords")
        _write_toy(path, _id_imgs(range(16)))
        with open(path, "ab") as f:
            jwriter.write_record(f, b"\x05not-a-proto")
    before = _tf_counter("data/corrupt_records_total")
    p = pds.TFRecordDataset(str(tmp_path / "port"), max_corrupt_frac=0.2)
    j = jds.TFRecordDataset(str(tmp_path / "jax"), max_corrupt_frac=0.2)
    p.set_quarantine_ledger(str(tmp_path / "p.jsonl"))
    j.set_quarantine_ledger(str(tmp_path / "j.jsonl"))
    _stream_equal(p.batches(4, seed=0), j.batches(4, seed=0), 12)
    assert _tf_counter("data/corrupt_records_total") == before + 1
    got, want = _ledger_view(tmp_path / "p.jsonl"), \
        _ledger_view(tmp_path / "j.jsonl")
    assert len(got) == 1 and got[0]["cause"] == want[0]["cause"]
    assert {k: v for k, v in got[0].items() if k != "file"} == \
        {k: v for k, v in want[0].items() if k != "file"}


def test_payload_crc_quarantine_matches_jax(tmp_path):
    """Native path: a flipped payload byte fails the record's CRC at index
    build; the index and the ledger are JAX's."""
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
        path = str(tmp_path / side / "toy-r03.tfrecords")
        _write_toy(path, _id_imgs(range(8)))
        data = bytearray(open(path, "rb").read())
        offs, _, _ = native.scan_records(bytes(data), verify_crc=True)
        data[int(offs[3]) + 7] ^= 0xFF
        open(path, "wb").write(bytes(data))
    p = pds.TFRecordDataset(str(tmp_path / "port"), max_corrupt_frac=0.2)
    j = jds.TFRecordDataset(str(tmp_path / "jax"), max_corrupt_frac=0.2)
    p.set_quarantine_ledger(str(tmp_path / "p.jsonl"))
    j.set_quarantine_ledger(str(tmp_path / "j.jsonl"))
    assert p.num_images == j.num_images == 7
    got, want = _ledger_view(tmp_path / "p.jsonl"), \
        _ledger_view(tmp_path / "j.jsonl")
    assert [r["cause"] for r in got] == [r["cause"] for r in want] == \
        ["payload-crc"]
    assert got[0]["offset"] == want[0]["offset"]
    _stream_equal(p.batches(7, seed=0), j.batches(7, seed=0), 3)


def test_budget_error_matches_jax(tmp_path):
    path = str(tmp_path / "toy-r03.tfrecords")
    _write_toy(path, _id_imgs(range(16)))
    with open(path, "ab") as f:
        jwriter.write_record(f, b"\x05not-a-proto")
    errors = []
    for mod, exc in ((pds, DataCorrupt), (jds, JaxDataCorrupt)):
        it = mod.TFRecordDataset(str(tmp_path),
                                 max_corrupt_frac=0.0).batches(4, seed=0)
        with pytest.raises(exc, match="max_corrupt_frac") as e:
            for _ in range(12):
                next(it)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_read_retry_via_fault(tmp_path, no_faults):
    path = str(tmp_path / "toy-r03.tfrecords")
    _write_toy(path, _id_imgs(range(16)))
    ds = pds.TFRecordDataset(str(tmp_path), io_retry_base_s=0.01)
    ref = [next(it)["image"] for it in [ds.batches(4, seed=1)]
           for _ in range(4)]
    faults.arm(faults.parse_specs("raise@data_read_error:n=6"))
    before = _tf_counter("data/read_retries_total")
    got = [next(it)["image"] for it in [ds.batches(4, seed=1)]
           for _ in range(4)]
    assert _tf_counter("data/read_retries_total") == before + 1
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_corrupt_record_fault_quarantines(tmp_path, no_faults):
    path = str(tmp_path / "toy-r03.tfrecords")
    _write_toy(path, _id_imgs(range(16)))
    ds = pds.TFRecordDataset(str(tmp_path), max_corrupt_frac=0.2)
    faults.arm(faults.parse_specs("raise@data_corrupt_record:n=3"))
    before = _tf_counter("data/corrupt_records_total")
    next(ds.batches(4, seed=0))
    assert _tf_counter("data/corrupt_records_total") == before + 1


def test_prefetch_order_and_watchdog():
    import time as _time

    it = pds.PrefetchIterator(iter([{"i": i} for i in range(5)]), depth=2)
    assert [b["i"] for b in it] == list(range(5))

    def stalling():
        yield {"i": 0}
        _time.sleep(30.0)
        yield {"i": 1}

    before = _tf_counter("data/stalls_total")
    with pds.PrefetchIterator(stalling(), depth=1, stall_after_s=0.3) as it:
        assert next(it)["i"] == 0
        with pytest.raises(DataStalled, match="no progress"):
            next(it)
    assert _tf_counter("data/stalls_total") == before + 1


def test_prefetch_propagates_producer_error():
    def bad():
        yield {"i": 0}
        raise RuntimeError("producer broke")

    it = pds.PrefetchIterator(bad(), depth=2)
    assert next(it)["i"] == 0
    with pytest.raises(RuntimeError, match="producer broke"):
        next(it)
