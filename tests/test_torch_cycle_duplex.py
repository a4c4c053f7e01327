"""One lazy-regularization cycle of the port's steps against JAX's fused
cycle for the ``duplex`` model of ``tests/test_torch_train.py``: the tests
and the rules of ``tests/test_torch_cycle.py`` (with the attention on,
the reference is JAX's float64 cycle), in a file of their own so that
``--dist loadfile`` runs each model's cycle on a worker of its own."""

import pytest

from tests.test_torch_cycle import (  # noqa: F401  (tests run here too)
    cycle_setup, test_cycle_aux_sums_match_jax, test_cycle_counts_are_jaxs,
    test_cycle_state_matches_jax)

cycle_vs_jax = pytest.fixture(scope="module",
                              params=["duplex"])(cycle_setup)
