"""torch on one thread in the port's tests.

The tier-1 run has six pytest-xdist workers on the host's cores.
torch would give each worker an OpenMP thread per core, and six pools of
spinning threads slow every worker several times over (JAX's compiles in
the other workers too), while the port's micro-width ops gain nothing
from a pool.  Importing ``one_thread`` into a test module
applies it to that module (an autouse fixture); the processes a test
starts (the CLIs) inherit ``OMP_NUM_THREADS=1``.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env
