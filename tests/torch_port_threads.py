"""torch on one thread for a port test module: import ``one_torch_thread``
into it. Beside the suite's parallel workers, the small ops of these
modules' fits otherwise spend most of their time in an oversubscribed
intra-op thread pool (a two-epoch flagship fit: ~22 s on 8 threads under
load, ~2.2 s on one)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
