"""One PyTorch thread for a test module of the port.

``from torch_threads import torch_one_thread`` in a test module pins
PyTorch's intra-op thread pool to one thread while the module's tests
and fixtures run (autouse) and restores it after.  The port's CPU tests
are many small operations: a pool of one thread per core spends them
spinning, and under the suite's parallel workers it takes the cores
from the other workers (``test_torch_kernel_layout.py`` alone on an
8-core host: 87 s with the pool, 24 s on one thread; the ranks
``launch.spawn`` starts already run on one thread).
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
