"""One ``d_step`` and one ``g_step`` of the port against JAX's for the
micro duplex generators of ``STEP_MODELS`` (attention on, and with the
discriminator's attention and fused K/V too): the tests and the rules of
``tests/test_torch_train.py``, in a file of their own so that
``--dist loadfile`` runs them beside that file's other tests."""

import pytest

from tests.test_torch_train import (  # noqa: F401  (tests run here too)
    steps_setup, test_d_step_gradients_and_update_match_jax,
    test_g_step_gradients_update_ema_and_w_avg_match_jax,
    test_train_state_bridge_round_trip_and_errors)
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

steps_vs_jax = pytest.fixture(scope="module", params=[
    "duplex", "duplex_fusedkv"])(steps_setup)
