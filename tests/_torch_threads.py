"""A module-scoped autouse fixture that runs a test module's torch CPU
work on one intra-op thread.

These modules run many small tensor operations (campaign rounds at scale
0.002, checkpoints of small trees).  Under the suite's pytest-xdist
workers, several processes on the machine's cores, each torch thread pool
oversubscribes the cores: the campaign command's tests took 172 s in
parallel against 8 s alone, and 8 s on one thread in parallel.  The
previous thread count is restored after the module.

Use: ``from _torch_threads import one_intra_op_thread  # noqa: F401``.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
