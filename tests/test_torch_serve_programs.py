"""The port's serve programs beyond synthesis, on the CPU:
``load_generator`` (the G-only restore) against the JAX package's on a
run dir of each package, the programs' counters and the warm start's
report off the card.

Run dirs: the micro duplex configuration of ``tests/test_torch_generate``
(and one with D's attention, so the discriminator's leaves sit between
G's and the EMA's), each a checkpoint of a perturbed state: the port's
written by the port's ``checkpoint.save``, the JAX one by the JAX
package's.  Held bit for bit: every EMA leaf and ``w_avg``.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from gansformer_tpu.core.config import ExperimentConfig as JaxExperiment
from gansformer_tpu.serve import load_generator as jax_load_generator
from gansformer_tpu_torch import bridge
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.models import discriminator
from gansformer_tpu_torch.obs import registry as telemetry
from gansformer_tpu_torch.serve import (WARM_KINDS, ServePrograms,
                                        load_generator)
from gansformer_tpu_torch.train import checkpoint as ckpt
from gansformer_tpu_torch.train import create_train_state, state
from tests.test_torch_checkpoint import perturbed_flat
from tests.test_torch_generate import _exp, _jax_run
from tests.torch_threads import one_thread  # noqa: F401  (autouse)


def _port_run(root, jexp):
    run = os.path.join(root, "port_run")
    exp = port_config.ExperimentConfig.from_json(jexp.to_json())
    st = create_train_state(exp.model, exp.train, 0, "cpu")
    bridge.load_train_state(st, perturbed_flat(jexp, seed=4))
    ckpt.save(os.path.join(run, "checkpoints"), st, block=True)
    with open(os.path.join(run, "config.json"), "w") as f:
        f.write(exp.to_json())
    return run


@pytest.fixture(scope="module", params=["duplex", "duplex_d_attention"])
def runs(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runs"))
    exp = _exp()
    if request.param == "duplex_d_attention":
        exp = dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, d_attention=True))
    jexp = JaxExperiment.from_json(exp.to_json())
    return {"port": _port_run(root, jexp), "jax": _jax_run(root, jexp)}


@pytest.mark.parametrize("src", ["port", "jax"])
def test_load_generator_matches_jax(runs, src, monkeypatch):
    """Both packages' G-only restores of one run dir agree bit for bit;
    the port's builds no discriminator and no train state, and sets
    ``serve/restore_ms``."""
    run = runs[src]
    ref = jax_load_generator(run)
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jax.device_get(ref.ema_params), sep="/").items()}

    def refuse(*a, **k):
        raise AssertionError("the G-only restore built a D or a state")

    monkeypatch.setattr(discriminator.Discriminator, "__init__", refuse)
    monkeypatch.setattr(state, "create_train_state", refuse)
    telemetry.gauge("serve/restore_ms").set(-1.0)
    bundle = load_generator(run, device="cpu")
    assert telemetry.gauge("serve/restore_ms").value >= 0.0
    got = {k.replace(".", "/"): p.detach().numpy()
           for k, p in bundle.generator.named_parameters()}
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    assert np.array_equal(bundle.w_avg.numpy(), np.asarray(ref.w_avg))
    assert bundle.device.type == "cpu" and not bundle.generator.training


def test_load_generator_refuses_another_model(runs, tmp_path):
    """A run dir whose checkpoint is not a state of the configured
    generator raises, naming the mismatch."""
    with open(os.path.join(runs["port"], "config.json")) as f:
        exp = port_config.ExperimentConfig.from_json(f.read())
    other = dataclasses.replace(exp, model=dataclasses.replace(
        exp.model, mapping_layers=exp.model.mapping_layers + 1))
    with pytest.raises(ValueError, match="mismatch"):
        load_generator(runs["port"], cfg=other, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_generator(runs["port"], step=12345, device="cpu")


def test_programs_counters_and_warm_start_off_the_card(runs):
    """The dispatch counters exist from construction and count each
    program call; off the card the warm start loads and builds nothing
    (the plain versions need no library)."""
    bundle = load_generator(runs["port"], device="cpu")
    reg = telemetry.get_registry()
    reg.reset()
    progs = ServePrograms(bundle, buckets=(1, 2))
    snap = reg.snapshot()["counters"]
    assert {k: snap[k] for k in ("serve/map_dispatch_total",
                                 "serve/synth_dispatch_total",
                                 "serve/compiles_total")} == dict.fromkeys(
        ("serve/map_dispatch_total", "serve/synth_dispatch_total",
         "serve/compiles_total"), 0.0)
    ws = progs.map_seeds([1, 2])
    progs.map_z(np.zeros((1, bundle.cfg.num_ws, bundle.cfg.latent_dim),
                         np.float32))
    progs.synthesize(ws, [0.7, 0.7])
    snap = reg.snapshot()["counters"]
    assert snap["serve/map_dispatch_total"] == 2
    assert snap["serve/synth_dispatch_total"] == 1
    assert progs.warm_start() == {"loaded": 0, "compiled": 0,
                                  "seconds": 0.0}
    assert WARM_KINDS == ("map_seeds", "synthesize")
    assert not ServePrograms(bundle, manifest_dir=None).warm_start_enabled
    assert ServePrograms(bundle, manifest_dir="m").warm_start_enabled
    assert not ServePrograms(bundle, manifest_dir="m",
                             warm_start=False).warm_start_enabled


def test_noise_is_drawn_where_asked(runs, monkeypatch):
    """``noise_device`` names where the noise generators draw (default:
    the program's device); a draw on the CPU gives a CPU program the same
    images as its default."""
    from gansformer_tpu_torch.serve import programs

    progs = ServePrograms(load_generator(runs["port"], device="cpu"),
                          buckets=(2,))
    ws = progs.map_seeds([5, 6])
    seen = []
    real = programs.noise_generators

    def spy(seed, tags, device):
        seen.append(torch.device(device))
        return real(seed, tags, device)

    monkeypatch.setattr(programs, "noise_generators", spy)
    a = progs.synthesize(ws, [0.7, 1.0], seed=3, tags=[5, 6])
    b = progs.synthesize(ws, [0.7, 1.0], seed=3, tags=[5, 6],
                         noise_device="cpu")
    assert seen == [progs.device, torch.device("cpu")]
    assert torch.equal(a, b)
