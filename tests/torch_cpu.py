"""One intra-op thread for the port's CPU tests.

The suite runs in several pytest-xdist workers at once, and each worker
imports every test module when it collects. PyTorch's default of one
intra-op thread a core in each of them oversubscribes the host: its
parallel CPU kernels then spend most of their time waiting: six
workers on eight cores took 1,432 s of worker time for the port's test
files with the default and 521 s with one thread each (``--durations=0``
summed). The port's test files import this module first.
"""

import torch

torch.set_num_threads(1)
