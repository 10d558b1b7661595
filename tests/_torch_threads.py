"""One torch intra-op thread while a port test module runs.

The test runner's parallel workers each hold a torch process that, by
default, runs an intra-op thread per core. On a host of a few cores the
workers oversubscribe it, and every parallel op waits on the other
workers' threads: ``tests/test_torch_prng.py``, chains of hundreds of
small int64 ops, took 388 s under six workers against 46 s alone, and
1046 s beside five busy torch processes against 52 s with one thread.
The port's test modules import ``one_intra_op_thread`` (an autouse,
module-scoped fixture); the previous count is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
