"""One ``d_step_r1`` of the port against JAX's with the discriminator's
attention on (``d_attention``), at ``r1_batch_shrink`` 1 and 2: the tests
and the rules of ``tests/test_torch_r1.py``, in a file of their own so
that ``--dist loadfile`` runs them beside that file's other cases."""

import pytest

from tests.test_torch_r1 import (  # noqa: F401  (tests run here too)
    r1_setup, test_d_step_r1_matches_jax,
    test_d_step_r1_on_the_cards_route_matches_jax_and_the_plan,
    test_planted_second_order_drop_fails_the_comparison)
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

r1_vs_jax = pytest.fixture(scope="module", params=[
    "d_attention-shrink1", "d_attention-shrink2"])(r1_setup)
