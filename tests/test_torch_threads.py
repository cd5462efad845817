"""Torch's CPU thread count in a pytest-xdist worker: one.

Every xdist worker imports every test module while it collects, before it
runs any test, so importing this module sets the count for all of that
worker's torch tests. The workers already share the host's cores; a torch
op with one thread per core then waits at each of its parallel regions
for threads that the other workers keep off the cores, and the CPU
versions of the tiled kernels run thousands of small ops per fit (a
tiled Lanczos fit that takes 1.6 s alone took minutes among six
workers). A single-process run keeps torch's default. JAX has a thread
pool of its own and is not affected.
"""

import os

import torch

IN_XDIST_WORKER = "PYTEST_XDIST_WORKER" in os.environ

if IN_XDIST_WORKER:
    torch.set_num_threads(1)


def test_xdist_workers_run_torch_on_one_thread():
    assert torch.get_num_threads() == 1 or not IN_XDIST_WORKER
