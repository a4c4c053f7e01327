"""The port's warm start of the kernel library (``serve/warmstart.py``) on
the CPU.  This host has no ``nvcc``, so the library is a stand-in with
``ops/_build.py``'s interface: one C function built by g++ (as the port's
``native/`` host ops are), its "toolkit" a version string.  Held: a cold
manifest builds and records; a valid entry loads with no build; every
kind of stale entry (an edited source, a torn manifest, a checksum that
drifted, a missing file, a file that fails to load, another toolkit) is
counted, rebuilt and rewritten, never a crash; a library already built
there with no entry is adopted, and torch's version and the card's name
do not stale an entry; the cold path; the real
build's digest covers ``nvcc --version``; and the port's serving code
never names the JAX package's compile cache.
"""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.ops import _build
from gansformer_tpu_torch.serve import warmstart
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Loads a library in a fresh interpreter and prints gt_answer(): each load
# is a new process, as each serving process is (a process that dlopen()ed
# a path gets that handle back for the same path).
_LOAD = ("import ctypes, sys; lib = ctypes.CDLL(sys.argv[1]); "
         "print(lib.gt_answer())")


class GppLibrary:
    """``ops/_build.py``'s interface over ``int gt_answer(void)``;
    ``handle`` is the loaded library's answer."""

    def __init__(self, src_dir, version="stand-in nvcc 12.8"):
        self.src = os.path.join(src_dir, "kernels.c")
        if not os.path.exists(self.src):
            self.edit(42)
        self.version = version
        self.builds = 0
        self.handle = None

    def edit(self, answer):
        with open(self.src, "w") as f:
            f.write(f"int gt_answer(void) {{ return {answer}; }}\n")

    def _digest(self):
        with open(self.src, "rb") as f:
            return hashlib.sha256(f.read() + self.version.encode()
                                  ).hexdigest()[:16]

    def signature(self):
        return {"sources": self._digest(), "nvcc": self.version,
                "arch_flags": [], "nvcc_flags": ["-O2"], "torch": "x",
                "device": "stand-in", "capability": [9, 0]}

    def library_path(self, build_root=None):
        return os.path.join(build_root, self._digest(), "libkernels.so")

    def build(self, build_root=None):
        path = self.library_path(build_root)
        if os.path.exists(path):
            return path
        os.makedirs(os.path.dirname(path), exist_ok=True)
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-x", "c",
                        "-o", path + ".tmp", self.src], check=True,
                       capture_output=True, timeout=120)
        os.replace(path + ".tmp", path)
        self.builds += 1
        return path

    def load_path(self, path):
        out = subprocess.run([sys.executable, "-c", _LOAD, path],
                             capture_output=True, text=True, timeout=60)
        if out.returncode != 0:
            raise OSError(f"{path}: {out.stderr.strip()[-200:]}")
        self.handle = int(out.stdout)
        return self.handle

    def loaded(self):
        return self.handle is not None


def _counts():
    return {k: telemetry.counter(f"serve/{k}").value for k in
            ("warm_hits_total", "manifest_stale_total", "compiles_total")}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _entry(d):
    with open(os.path.join(d, warmstart.MANIFEST)) as f:
        return json.load(f)["entries"][warmstart.ENTRY]


@pytest.fixture
def lib(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("the stand-in library is built by g++")
    return GppLibrary(str(tmp_path))


def test_cold_then_warm(lib, tmp_path):
    d = str(tmp_path / "manifest")
    c0 = _counts()
    cold = warmstart.warm_start(d, lib)
    assert (cold["loaded"], cold["compiled"]) == (0, 1) and lib.builds == 1
    assert lib.handle == 42
    entry = _entry(d)
    assert entry["signature"] == lib.signature()
    assert entry["file"] == os.path.relpath(lib.library_path(d), d)
    with open(lib.library_path(d), "rb") as f:
        assert entry["sha256"] == hashlib.sha256(f.read()).hexdigest()
    fresh = GppLibrary(str(tmp_path))         # a new process
    warm = warmstart.warm_start(d, fresh)
    assert (warm["loaded"], warm["compiled"]) == (1, 0) and fresh.builds == 0
    assert fresh.handle == 42
    assert _delta(c0) == {"warm_hits_total": 1, "manifest_stale_total": 0,
                          "compiles_total": 1}


def _stale_source(lib, d):
    lib.edit(7)


def _torn_manifest(lib, d):
    with open(os.path.join(d, warmstart.MANIFEST), "w") as f:
        f.write('{"version": 1, "entr')


def _checksum_drift(lib, d):
    with open(lib.library_path(d), "ab") as f:
        f.write(b"\0")


def _missing_file(lib, d):
    os.remove(lib.library_path(d))


def _fails_to_load(lib, d):
    path = lib.library_path(d)
    with open(path, "wb") as f:
        f.write(b"not an ELF file")
    with open(os.path.join(d, warmstart.MANIFEST)) as f:
        m = json.load(f)
    with open(path, "rb") as f:   # a checksum that agrees with the junk
        m["entries"][warmstart.ENTRY]["sha256"] = hashlib.sha256(
            f.read()).hexdigest()
    with open(os.path.join(d, warmstart.MANIFEST), "w") as f:
        json.dump(m, f)


def _new_toolkit(lib, d):
    lib.version = "stand-in nvcc 12.9"


@pytest.mark.parametrize("spoil", [_stale_source, _torn_manifest,
                                   _checksum_drift, _missing_file,
                                   _fails_to_load, _new_toolkit],
                         ids=lambda f: f.__name__.strip("_"))
def test_stale_entries_rebuild_and_rewrite(lib, tmp_path, spoil):
    d = str(tmp_path / "manifest")
    warmstart.warm_start(d, lib)
    old = lib.library_path(d)
    spoil(lib, d)
    fresh = GppLibrary(str(tmp_path), version=lib.version)
    c0 = _counts()
    out = warmstart.warm_start(d, fresh)
    assert (out["loaded"], out["compiled"]) == (0, 1) and fresh.builds == 1
    assert _delta(c0) == {"warm_hits_total": 0, "manifest_stale_total": 1,
                          "compiles_total": 1}
    answer = 7 if spoil is _stale_source else 42
    assert fresh.handle == answer
    assert _entry(d)["signature"] == fresh.signature()
    if fresh.library_path(d) != old:      # the stale build is gone
        assert not os.path.exists(os.path.dirname(old))
    again = GppLibrary(str(tmp_path), version=lib.version)
    assert warmstart.warm_start(d, again)["loaded"] == 1


def test_a_prebuilt_library_without_an_entry_is_adopted(lib, tmp_path):
    """A library the lazy build already put in the directory (no
    manifest) is loaded and recorded, not removed and rebuilt."""
    d = str(tmp_path / "manifest")
    built = lib.build(d)
    fresh = GppLibrary(str(tmp_path))
    c0 = _counts()
    out = warmstart.warm_start(d, fresh)
    assert (out["loaded"], out["compiled"]) == (1, 0) and fresh.builds == 0
    assert out["path"] == built and fresh.handle == 42
    assert _delta(c0) == {"warm_hits_total": 0, "manifest_stale_total": 0,
                          "compiles_total": 0}
    with open(built, "rb") as f:
        assert _entry(d)["sha256"] == hashlib.sha256(f.read()).hexdigest()
    again = GppLibrary(str(tmp_path))
    assert warmstart.warm_start(d, again)["loaded"] == 1
    assert _delta(c0)["warm_hits_total"] == 1


@pytest.mark.parametrize("key,value", [("torch", "another torch"),
                                       ("device", "another H100")])
def test_torch_and_card_name_are_recorded_not_compared(lib, tmp_path, key,
                                                       value):
    """The library is a plain C interface for the card's compute
    capability: torch's version and the card's name do not stale it."""
    d = str(tmp_path / "manifest")
    warmstart.warm_start(d, lib)
    fresh = GppLibrary(str(tmp_path))
    sig = dict(fresh.signature(), **{key: value})
    fresh.signature = lambda: sig
    c0 = _counts()
    out = warmstart.warm_start(d, fresh)
    assert (out["loaded"], out["compiled"]) == (1, 0) and fresh.builds == 0
    assert _delta(c0)["warm_hits_total"] == 1
    assert key not in warmstart.VALID_FOR


def test_cold_start_builds_once_and_records_nothing(lib, tmp_path):
    root = str(tmp_path / "build")
    c0 = _counts()
    out = warmstart.cold_start(root, lib)
    assert (out["loaded"], out["compiled"]) == (0, 1)
    assert not os.path.exists(os.path.join(root, warmstart.MANIFEST))
    fresh = GppLibrary(str(tmp_path))
    assert warmstart.cold_start(root, fresh)["compiled"] == 0
    assert fresh.handle == 42
    assert warmstart.cold_start(root, fresh) == {
        "loaded": 0, "compiled": 0, "seconds": 0.0, "path": None}
    assert _delta(c0)["compiles_total"] == 1


def test_build_digest_covers_the_toolkit(monkeypatch, tmp_path):
    """A new ``nvcc`` never loads an old library: its version is in the
    digest that names the build directory."""
    monkeypatch.setattr(_build, "_nvcc_version", "Cuda compilation tools, "
                        "release 12.8")
    a = _build.library_path(str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc_version", "Cuda compilation tools, "
                        "release 12.9")
    b = _build.library_path(str(tmp_path))
    assert a != b
    assert os.path.dirname(os.path.dirname(a)) == str(tmp_path)
    assert _build.library_path().startswith(_build.BUILD_ROOT)


def test_serving_code_never_names_the_jax_compile_cache():
    """The port's serving, warm-start and build code keeps its library
    under the package's own build directory."""
    pkg = ROOT / "gansformer_tpu_torch"
    files = sorted((pkg / "serve").glob("*.py")) + [
        pkg / "cli" / "serve.py", pkg / "cli" / "generate.py",
        pkg / "ops" / "_build.py"]
    for path in files:
        assert ".jax_compile_cache" not in path.read_text(), path
    assert warmstart.default_manifest_dir() == _build.BUILD_ROOT
    assert pathlib.Path(_build.BUILD_ROOT).parent == pkg
