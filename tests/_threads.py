"""The autouse one-thread fixture of the port's slow CPU test files.

A test file takes it with ``from _threads import _one_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    # the plain versions' ops are many and small: one thread each keeps a
    # test's time steady when test workers share the cores
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(kept)
