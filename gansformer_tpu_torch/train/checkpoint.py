"""Checkpoints of the port: crash-safe, resumable, and in the JAX package's
on-disk format, so each package resumes from the other's
(``gansformer_tpu/train/checkpoint.py``, rewritten for torch).

Layout: ``<ckpt_dir>/<step>/state.npz`` holds ``__step`` (int64) and
``leaf_%05d``, the JAX ``TrainState``'s leaves in ``tree_flatten`` order
(``bridge.jax_leaf_keys``): ``step``, G's, D's parameters, G's and D's
Adam ``count, mu, nu``, the EMA parameters, ``w_avg``, ``pl_mean``;
``step`` and the counts int32, the rest fp32.  The port reaches that
order from its own parameter names; torch's per-parameter Adam ``step``
becomes optax's one ``count`` (``bridge.adam_count``).  The resolved
``config.json`` (JAX's ``to_json`` layout) sits beside the steps.

Writes are atomic: serialize into a temp directory named by process and
thread, fsync, move an existing same-step directory aside, rename into
place, fsync the parent, then apply retention.  ``save(block=False)``
costs the loop thread the start of the device-to-host copies (into
pinned host buffers, reused across saves, ordered on the stream after
the steps that made the state); the single-slot writer thread waits for
them, serializes and renames.  Writer failures are sticky and surface at
the loop's next ``check_error``.  ``restore`` walks back past a torn or
mismatched latest step, quarantining it as ``<step>.corrupt``; an
explicit ``step`` fails hard.

Telemetry: ``ckpt/write_ms`` (loop thread), ``ckpt/save_total``,
``ckpt/restore_ms``, ``ckpt/restore_fallback_total``, and the writer's
``ckpt/async_*``.  Fault points: ``ckpt_mid_write`` (after the temp file,
before the rename) and ``ckpt_after_write`` (``torn`` truncates the
landed file).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from gansformer_tpu_torch import bridge
from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.obs.spans import span
from gansformer_tpu_torch.supervise import faults
from gansformer_tpu_torch.utils.background import SingleSlotWriter

STATE_FILE = "state.npz"

_WRITERS: Dict[str, SingleSlotWriter] = {}
# Pinned host buffers of the async path, per checkpoint directory; reused
# only after the writer that read them has finished (single slot).
_STAGING: Dict[str, List[torch.Tensor]] = {}

# Serializes the final-directory swap across threads: the preemption path
# may sync-save the step a timed-out async writer is still finishing.
_SWAP_LOCK = threading.Lock()

# Test seam: called with the step after the temp file is written, before
# the rename; a hook that raises models a crash mid-write.
_WRITE_HOOK: Optional[Callable[[int], None]] = None


def _writer(ckpt_dir: str) -> SingleSlotWriter:
    key = os.path.abspath(ckpt_dir)
    if key not in _WRITERS:
        _WRITERS[key] = SingleSlotWriter("ckpt/async")
    return _WRITERS[key]


def _leaf_key(i: int) -> str:
    return f"leaf_{i:05d}"


def leaf_dtype(key: str) -> np.dtype:
    return np.dtype(np.int32 if key in bridge.INT_KEYS else np.float32)


def state_leaves(state) -> list:
    """The state's leaves in the JAX order: torch tensors for the arrays,
    int32 numpy scalars for ``step`` and the counts."""
    flat = bridge.port_train_state_flat(state)
    return [np.asarray(flat[k], np.int32) if k in bridge.INT_KEYS
            else flat[k] for k in bridge.jax_leaf_keys(state)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, np.ndarray):
        return leaf
    return leaf.detach().to("cpu", torch.float32).numpy()


def _write_state_dir(ckpt_dir: str, step: int, host_leaves: List[np.ndarray],
                     max_to_keep: int) -> None:
    """Serialize -> temp dir -> fsync -> atomic rename.  A failure removes
    the temp dir and re-raises; the previous checkpoint is never
    touched."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(
        ckpt_dir, f".tmp-{step}-{os.getpid()}-{threading.get_ident()}")
    final = os.path.join(ckpt_dir, str(step))
    trash = None
    try:
        os.makedirs(tmp, exist_ok=True)
        path = os.path.join(tmp, STATE_FILE)
        with open(path, "wb") as f:
            np.savez(f, __step=np.int64(step),
                     **{_leaf_key(i): l for i, l in enumerate(host_leaves)})
            f.flush()
            os.fsync(f.fileno())
        if _WRITE_HOOK is not None:
            _WRITE_HOOK(step)
        faults.fire("ckpt_mid_write", step=step)
        with _SWAP_LOCK:
            if os.path.isdir(final):
                # a re-save of the same step: the old dir goes aside and
                # is deleted only once the new one is in place
                trash = tmp + ".old"
                os.rename(final, trash)
            os.replace(tmp, final)
            dfd = os.open(ckpt_dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        if trash is not None:
            shutil.rmtree(trash, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if trash is not None and not os.path.isdir(final):
            try:
                os.rename(trash, final)
            except OSError:
                pass
        raise
    faults.fire("ckpt_after_write", step=step,
                path=os.path.join(final, STATE_FILE))
    _apply_retention(ckpt_dir, keep=max_to_keep)


def _apply_retention(ckpt_dir: str, keep: int) -> None:
    if keep <= 0:
        return
    for s in _all_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(s)), ignore_errors=True)


def _staging(ckpt_dir: str, leaves) -> List[Optional[torch.Tensor]]:
    """Pinned host buffers for the tensor leaves (None for the int
    leaves), reused while the shapes hold."""
    key = os.path.abspath(ckpt_dir)
    want = [None if isinstance(l, np.ndarray) else tuple(l.shape)
            for l in leaves]
    bufs = _STAGING.get(key)
    if bufs is None or [None if b is None else tuple(b.shape)
                        for b in bufs] != want:
        bufs = [None if s is None else torch.empty(
            s, dtype=torch.float32, pin_memory=True) for s in want]
        _STAGING[key] = bufs
    return bufs


def warm_async(state, ckpt_dir: str) -> None:
    """Allocate the pinned staging buffers during setup, so the first
    in-loop async save costs what every later one does."""
    if state.device.type == "cuda":
        _staging(ckpt_dir, state_leaves(state))


def save(ckpt_dir: str, state, cfg=None, max_to_keep: int = 5,
         block: bool = True) -> None:
    """Write one checkpoint step (``state.step``).  ``block=False``: the
    calling thread joins the previous async save, starts the copies and
    hands the rest to the writer thread (call ``check_error`` at tick
    boundaries and ``wait`` before reading ``latest_step``).
    ``block=True`` writes inline.  ``cfg`` (an ``ExperimentConfig``)
    goes to ``<ckpt_dir>/config.json`` once."""
    step = int(state.step)
    with span("ckpt/save") as sp:
        leaves = state_leaves(state)
        if block:
            _write_state_dir(ckpt_dir, step, [_host(l) for l in leaves],
                             max_to_keep)
        else:
            writer = _writer(ckpt_dir)
            writer.wait()            # the staging buffers are free again
            if state.device.type == "cuda":
                bufs = _staging(ckpt_dir, leaves)
                for b, l in zip(bufs, leaves):
                    if b is not None:
                        b.copy_(l, non_blocking=True)
                done = torch.cuda.Event()
                done.record()

                def host_leaves():
                    done.synchronize()
                    return [l if b is None else b.numpy()
                            for b, l in zip(bufs, leaves)]
            else:
                snap = [l if isinstance(l, np.ndarray)
                        else l.detach().clone() for l in leaves]

                def host_leaves():
                    return [_host(l) for l in snap]
            writer.submit(
                lambda: _write_state_dir(ckpt_dir, step, host_leaves(),
                                         max_to_keep),
                label=f"step {step}")
    telemetry.gauge("ckpt/write_ms").set(sp.duration_s * 1000.0)
    telemetry.counter("ckpt/save_total").inc()
    if cfg is not None:
        cfg_path = os.path.join(ckpt_dir, "config.json")
        if not os.path.exists(cfg_path):
            os.makedirs(ckpt_dir, exist_ok=True)
            with open(cfg_path, "w") as f:
                f.write(cfg.to_json())


def reset_errors(ckpt_dir: str) -> None:
    """Run start: drop an undelivered writer error a previous run in this
    process left on the directory's writer."""
    key = os.path.abspath(ckpt_dir)
    if key in _WRITERS:
        _WRITERS[key].wait(reraise=False)
        _WRITERS[key].clear_error()


def check_error(ckpt_dir: str) -> None:
    """Re-raise a failed async write (the loop calls this every tick)."""
    key = os.path.abspath(ckpt_dir)
    if key in _WRITERS:
        _WRITERS[key].poll()


def wait(ckpt_dir: str, reraise: bool = True,
         timeout: Optional[float] = None) -> bool:
    """Join an in-flight async save; False when it is still running after
    ``timeout``.  ``reraise=False`` for ``finally`` blocks."""
    key = os.path.abspath(ckpt_dir)
    if key in _WRITERS:
        return _WRITERS[key].wait(reraise=reraise, timeout=timeout)
    return True


def _all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit()
                  and os.path.isdir(os.path.join(ckpt_dir, d)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _expected(state) -> Dict[str, tuple]:
    """{flat key: (shape, dtype)} of the state's leaves."""
    flat = bridge.port_train_state_flat(state)
    return {k: (tuple(np.shape(flat[k])) if k not in bridge.INT_KEYS
                else (), leaf_dtype(k)) for k in flat}


def _decode_leaf(arr: np.ndarray, want: tuple, path: str, k: str,
                 name: str) -> np.ndarray:
    shape, dtype = want
    if tuple(arr.shape) != shape or arr.dtype != dtype:
        raise ValueError(
            f"checkpoint {path} leaf {k} ({name}): {arr.dtype}{arr.shape} "
            f"does not match the state's {dtype}{shape}")
    return arr


def _read_leaves(path: str, state) -> Dict[str, np.ndarray]:
    """{flat key: array} of every leaf of the npz at ``path``, checked
    against ``state``."""
    keys = bridge.jax_leaf_keys(state)
    want = _expected(state)
    with np.load(path, allow_pickle=False) as z:
        names = sorted(k for k in z.files if k.startswith("leaf_"))
        if len(names) != len(keys):
            raise ValueError(
                f"checkpoint {path} has {len(names)} leaves, the state has "
                f"{len(keys)} — config/model mismatch?")
        return {k: _decode_leaf(z[n], want[k], path, n, k)
                for n, k in zip(names, keys)}


def restore_generator(ckpt_dir: str, generator, step: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
    """The EMA generator's leaves (``ema_params/...``) and ``w_avg`` of a
    checkpoint (the latest unless ``step``), checked against
    ``generator``'s shapes, with no discriminator or optimizer built: the
    JAX ``TrainState``'s leaves end with ``ema_params`` in tree order,
    ``w_avg``, ``pl_mean``, so they are read by position from the end.
    The count of the rest must fit G's leaves (step, G, D, both Adam
    states: 5 + 4 nG + 3 nD in all) or it raises."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    shapes = bridge.param_shapes(generator)
    names = bridge._tree_order(shapes)
    n_g = len(names)
    path = os.path.join(ckpt_dir, str(step), STATE_FILE)
    f32 = np.dtype(np.float32)
    with span("ckpt/restore_generator"), np.load(
            path, allow_pickle=False) as z:
        leaves = sorted(k for k in z.files if k.startswith("leaf_"))
        n_d, rest = divmod(len(leaves) - 5 - 4 * n_g, 3)
        if n_d < 0 or rest:
            raise ValueError(
                f"checkpoint {path} has {len(leaves)} leaves: not a state "
                f"of a generator with {n_g} leaves — config/model mismatch?")
        tail = leaves[-(n_g + 2):]
        out = {f"ema_params/{k}": _decode_leaf(
            z[lf], (shapes[k], f32), path, lf, f"ema_params/{k}")
            for k, lf in zip(names, tail)}
        w_dim = generator.cfg.w_dim
        out["w_avg"] = _decode_leaf(z[tail[n_g]], ((w_dim,), f32), path,
                                    tail[n_g], "w_avg")
        _decode_leaf(z[tail[n_g + 1]], ((), f32), path, tail[n_g + 1],
                     "pl_mean")
    return out


def _quarantine(ckpt_dir: str, step: int) -> str:
    """Rename a step dir that failed to decode to ``<step>.corrupt``
    (kept for a human, skipped by ``latest_step`` and retention)."""
    src = os.path.join(ckpt_dir, str(step))
    dst = os.path.join(ckpt_dir, f"{step}.corrupt")
    i = 0
    while os.path.exists(dst):
        i += 1
        dst = os.path.join(ckpt_dir, f"{step}.corrupt{i}")
    os.replace(src, dst)
    return dst


def restore(ckpt_dir: str, state, step: Optional[int] = None):
    """Load a checkpoint into ``state`` (the port's ``TrainState``, whose
    modules give the shapes) in place and return it.  The latest step is
    taken unless ``step`` is given; a latest step that fails to decode
    (torn, or not this state's leaves) is quarantined and the walk goes
    back to the newest one that decodes (``ckpt/restore_fallback_total``
    counts it).  An explicit ``step`` that fails raises."""
    explicit = step is not None
    candidates = [step] if explicit else list(reversed(_all_steps(ckpt_dir)))
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    last_err: Optional[Exception] = None
    flat = None
    with span("ckpt/restore") as sp:
        for s in candidates:
            npz = os.path.join(ckpt_dir, str(s), STATE_FILE)
            if not explicit and not os.path.isdir(os.path.dirname(npz)):
                continue             # quarantined by a peer meanwhile
            try:
                flat = _read_leaves(npz, state)
                break
            except Exception as e:
                if explicit:
                    raise
                try:
                    quarantined = _quarantine(ckpt_dir, s)
                except OSError:
                    quarantined = f"{s}.corrupt (by a peer process)"
                telemetry.counter("ckpt/restore_fallback_total").inc()
                print(f"[ckpt] step {s} failed to decode "
                      f"({type(e).__name__}: {str(e)[:200]}); quarantined "
                      f"to {quarantined}, walking back", flush=True)
                last_err = e
        else:
            err = ValueError(
                f"no checkpoint under {ckpt_dir} decodes cleanly"
                + (f"; last error: {type(last_err).__name__}: {last_err}"
                   if last_err is not None else
                   " (every candidate vanished mid-walk)"))
            if last_err is not None:
                raise err from last_err
            raise err
        bridge.load_train_state(state, flat)
    telemetry.gauge("ckpt/restore_ms").set(sp.duration_s * 1000.0)
    return state
