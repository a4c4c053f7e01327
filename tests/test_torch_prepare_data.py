"""The port's ``prepare_data`` against the JAX package's CLI on the CPU:
the same arguments write byte-identical files (TFRecords at every level
of detail or the top one alone, labels, npz) from the synthetic source,
from a tiny CIFAR-10 directory the test writes as the pickled batches
the real export holds, and from a folder of PNGs (Pillow decodes them on
this host); the records read back through the port's TFRecord dataset
image for image.  The LSUN source raises the JAX reader's words where
the ``lmdb`` package is missing, the folder source names the host to
run it on where Pillow is missing, and the download flags are refused
without touching the network."""

import builtins
import os
import pickle

import numpy as np
import pytest

from gansformer_tpu.cli import prepare_data as jax_cli
from gansformer_tpu.data import tfrecord_writer as jax_writer
from gansformer_tpu_torch.cli import prepare_data as port_cli
from gansformer_tpu_torch.data import SyntheticDataset, TFRecordDataset
from gansformer_tpu_torch.data import tfrecord_writer as port_writer
from tests.torch_threads import one_thread  # noqa: F401  (autouse)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


def _both(tmp_path, args, out_name):
    """Each CLI with ``args`` and its own ``--out``: (JAX's out, port's)."""
    outs = []
    for side, main in (("jax", jax_cli.main), ("port", port_cli.main)):
        out = str(tmp_path / side / out_name)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        main(args + ["--out", out, "--name", "set"])
        outs.append(out)
    return outs


@pytest.mark.parametrize("extra", [[], ["--max-lod-only"]])
def test_synthetic_tfrecords_are_the_jax_clis_bytes(tmp_path, extra):
    j, p = _both(tmp_path, ["--synthetic", "--resolution", "32",
                            "--max-images", "70", "--to", "tfrecord"]
                 + extra, "tf")
    jf, pf = _files(j), _files(p)
    lods = [5] if extra else [5, 4, 3, 2]
    assert sorted(pf) == sorted(f"set-r{lod:02d}.tfrecords" for lod in lods)
    assert pf == jf
    ds = TFRecordDataset(p, resolution=32)
    want = SyntheticDataset(32, num_images=70)._make(np.arange(70))
    assert ds.num_images == 70
    np.testing.assert_array_equal(ds._emit(range(70))["image"], want)


def test_synthetic_npz_is_the_jax_clis_bytes(tmp_path):
    j, p = _both(tmp_path, ["--synthetic", "--resolution", "16",
                            "--max-images", "9", "--to", "npz"], "s.npz")
    assert open(p, "rb").read() == open(j, "rb").read()
    with np.load(p) as z:
        assert z["images"].shape == (9, 16, 16, 3) and "labels" not in z


def _cifar_dir(root, batches=(("data_batch_1", 40), ("data_batch_2", 30))):
    """Pickled CIFAR-10 batches as the real export holds them: bytes keys,
    ``data`` [n, 3072] uint8 rows (CHW), ``labels`` a list."""
    rs = np.random.RandomState(0)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    for name, n in batches:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (n, 3072)).astype(
                np.uint8), b"labels": list(rs.randint(0, 10, n))}, f)
    return d


@pytest.mark.parametrize("to,max_images", [("tfrecord", None),
                                           ("npz", 50)])
def test_cifar10_is_the_jax_clis_bytes(tmp_path, to, max_images):
    src = _cifar_dir(str(tmp_path))
    args = ["--cifar10-dir", src, "--resolution", "32", "--to", to]
    args += ["--max-images", str(max_images)] if max_images else []
    j, p = _both(tmp_path, args, "c.npz" if to == "npz" else "c")
    if to == "npz":
        assert open(p, "rb").read() == open(j, "rb").read()
        with np.load(p) as z:
            assert z["images"].shape == (50, 32, 32, 3)
            assert z["labels"].shape == (50, 10)
        return
    pf = _files(p)
    assert pf == _files(j) and "set-r05.labels" in pf
    imgs, labels = port_writer.load_cifar10(src)
    ji, jl = jax_writer.load_cifar10(src)
    np.testing.assert_array_equal(imgs, ji)
    np.testing.assert_array_equal(labels, jl)
    ds = TFRecordDataset(p, resolution=32)
    got = ds._emit(range(70))
    np.testing.assert_array_equal(got["image"], imgs)
    np.testing.assert_array_equal(got["label"], labels)


def test_cifar10_refuses_other_resolutions_and_empty_dirs(tmp_path):
    src = _cifar_dir(str(tmp_path))
    with pytest.raises(SystemExit, match="CIFAR-10 is 32"):
        port_cli.main(["--cifar10-dir", src, "--out",
                       str(tmp_path / "x.npz")])
    with pytest.raises(FileNotFoundError, match="no CIFAR-10 batches"):
        port_writer.load_cifar10(str(tmp_path))


def test_source_dir_is_the_jax_clis_bytes(tmp_path):
    from PIL import Image

    src = tmp_path / "folder"
    os.makedirs(src)
    rs = np.random.RandomState(1)
    for i, (h, w) in enumerate([(20, 28), (24, 24), (31, 17)]):
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(
            np.uint8)).save(str(src / f"im{i}.png"))
    j, p = _both(tmp_path, ["--source-dir", str(src), "--resolution", "16",
                            "--to", "tfrecord"], "f")
    assert _files(p) == _files(j)


def test_source_dir_without_pillow_names_the_host(tmp_path, monkeypatch):
    from PIL import Image

    src = tmp_path / "folder"
    os.makedirs(src)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(str(src / "a.png"))
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="on a host that has Pillow"):
        port_cli.main(["--source-dir", str(src), "--resolution", "8",
                       "--out", str(tmp_path / "o.npz")])


def test_lsun_without_lmdb_raises_the_jax_words(tmp_path):
    try:
        import lmdb  # noqa: F401
        pytest.fail("this host has lmdb; the test holds the words of a "
                    "host without it")
    except ImportError:
        pass
    with pytest.raises(ImportError) as pe:
        next(port_writer.iter_lsun_lmdb(str(tmp_path), 32))
    with pytest.raises(ImportError) as je:
        next(jax_writer.iter_lsun_lmdb(str(tmp_path), 32))
    assert str(pe.value) == str(je.value)
    assert "'lmdb' package" in str(pe.value)
    with pytest.raises(ImportError, match="'lmdb' package"):
        port_cli.main(["--lsun-lmdb-dir", str(tmp_path), "--out",
                       str(tmp_path / "l.npz")])


@pytest.mark.parametrize("flag", ["--download=cifar10", "--download-dir",
                                  "--mirror-url", "--download-no-verify"])
def test_download_flags_are_refused_without_the_network(tmp_path,
                                                         monkeypatch,
                                                         flag):
    import socket

    def no_network(*a, **k):
        raise AssertionError("prepare_data reached for the network")

    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.setattr(socket.socket, "connect", no_network)
    argv = [flag] if "=" in flag else [flag, "x"]
    with pytest.raises(SystemExit, match="needs the network"):
        port_cli.main(argv + ["--out", str(tmp_path / "d.npz")])
    assert not os.listdir(tmp_path)


def test_no_source_is_a_usage_error(tmp_path):
    with pytest.raises(SystemExit) as e:
        port_cli.main(["--out", str(tmp_path / "x.npz")])
    assert e.value.code == 2
