"""A module-scoped fixture for the port's CPU test files: torch on one
intra-op thread while the module runs.

The port's CPU tests run many small eager ops. With torch's default pool
(a thread a core) each op waits on every pool thread, and when other
processes hold the cores, as a test run's other workers do, that wait
dominates: under 6 pytest-xdist workers on an 8-core machine
``tests/test_torch_kernels.py::test_train_avt_calls_llm_100m_round`` took
692.74 s against 1 s alone, and a reduced Jamba round 39 s against 5 s.

A test module takes it with ``from torch_threads import one_intra_op_thread
# noqa: F401``; the previous thread count is restored after the module.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
