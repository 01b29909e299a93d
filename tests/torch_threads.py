"""The port's test modules share the host's cores with the rest of the suite.

Under ``pytest-xdist`` every worker runs its own torch, whose intra-op pool
takes every core by default: six workers on eight cores run 48 threads, and
a smoke model's small ops on many threads spend their time waiting for one
another at each op's barrier. A port test module imports ``shared_cores``,
an autouse fixture that gives torch in its worker the worker's share of the
cores, and the subprocesses the module starts (its CLI runs) the same
through ``OMP_NUM_THREADS``. Alone (no xdist) a module keeps every core.

    from torch_threads import shared_cores  # noqa: F401  (autouse)
"""
import os

import pytest
import torch


def worker_threads() -> int:
    """This process's cores over the xdist workers that share them."""
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (cores or 1) // workers)


@pytest.fixture(scope="module", autouse=True)
def shared_cores():
    """torch's intra-op threads (and ``OMP_NUM_THREADS`` for the module's
    subprocesses) at ``worker_threads()`` for the module, restored after."""
    threads = torch.get_num_threads()
    n = worker_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", str(n))
        torch.set_num_threads(n)
        yield n
    torch.set_num_threads(threads)
