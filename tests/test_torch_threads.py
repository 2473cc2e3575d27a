"""Two threads for each thread pool of a process that runs the port's tests.

The suite runs several pytest-xdist workers on the same cores, and every
worker collects every test file, this one included. torch's OpenMP pool and
the BLAS pools size themselves to the machine's cores, so six workers (and
the subprocesses their tests start) oversubscribe the cores many times over
and run tens of times slower than alone. Importing this module pins the
worker: torch's intra-op pool and, through threadpoolctl, every OpenMP and
BLAS pool already loaded run two threads, and OMP_NUM_THREADS=2 goes to
every subprocess the tests start.
"""

import os

import torch
from threadpoolctl import threadpool_info, threadpool_limits

THREADS = 2

os.environ["OMP_NUM_THREADS"] = str(THREADS)
torch.set_num_threads(THREADS)
_limits = threadpool_limits(THREADS)  # kept for the life of the process


def test_every_pool_runs_two_threads():
    assert torch.get_num_threads() == THREADS
    assert os.environ["OMP_NUM_THREADS"] == str(THREADS)
    pools = threadpool_info()
    assert pools and all(pool["num_threads"] <= THREADS for pool in pools), pools
