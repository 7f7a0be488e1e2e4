"""A module-scoped autouse fixture that runs a test module's torch work on
one thread, restoring the count after.

Import it into a test module (``from _torch_threads import
one_torch_thread``). The port's CPU tests run small tensors, where
torch's default of one thread per core gains little: it costs twice the
CPU time (``tests/test_torch_danube.py`` alone: 160 s of CPU at 8
threads, 75 s at 1), which the tier-1 run's parallel workers share.
"""

import pytest


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
