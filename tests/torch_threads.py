"""A test file that imports ``few_threads`` runs its torch work on two threads.

The suite's workers share the machine's cores, and torch's default of one
intra-op thread a core oversubscribes them: small CPU models then run many
times slower than alone. Two threads a worker keep the cores busy without
that; the previous count is restored after the file.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)
