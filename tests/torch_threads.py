"""Torch's intra-op thread count in the port's test processes.

pytest-xdist runs several workers on one host; at torch's default of one
OpenMP thread per core each, they oversubscribe the CPU many times over
and small ops spend their time waiting for each other. Every
tests/test_torch_*.py calls ``cap_threads()`` when it is imported, so each
worker keeps its share of the cores (a test run alone keeps them all),
and a test that wants more threads asks through ``threads(n)``, which
never goes above the share and restores the previous count."""

import contextlib
import os

import torch


def thread_share() -> int:
    """The cores of the host over the number of xdist workers (1 alone)."""
    return max(1, (os.cpu_count() or 1) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


def cap_threads() -> None:
    torch.set_num_threads(min(torch.get_num_threads(), thread_share()))


@contextlib.contextmanager
def threads(n: int):
    """Run the body with min(n, thread_share()) intra-op threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(min(n, thread_share()))
    try:
        yield
    finally:
        torch.set_num_threads(prev)
