"""One ``g_step_pl`` of the port against JAX's for the micro duplex
generator at ``pl_batch_shrink`` 1: the tests and the rules of
``tests/test_torch_pl.py`` (the reference JAX's step in float64, the
port's fp32 step held by the hazard-16 clause), in a file of its own so
that ``--dist loadfile`` runs each duplex case on a worker of its
own."""

import pytest

from tests.test_torch_pl import (  # noqa: F401  (tests run here too)
    pl_setup, test_g_step_pl_matches_jax,
    test_g_step_pl_on_the_cards_route_matches_and_launches_the_plan,
    test_planted_modconv_second_order_drop_fails_the_comparison)
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

pl_vs_jax = pytest.fixture(scope="module",
                           params=["duplex-shrink1"])(pl_setup)
