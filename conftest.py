"""The CPU test session's thread policy: one intra-op torch thread a process.

The tier-1 command (ROADMAP.md) runs six xdist workers side by side, and
torch starts one intra-op thread per core in each of them, so on an 8-core
host up to 48 torch threads contend for 8 cores beside XLA's own pools.  A
port test that runs a model on tiny frames is hundreds of small ops and pays
for that contention many times over.  Measured on an 8-core CPU host: the
SPVCNN ``run_train`` test took 8.7 s alone and 245 s inside the suite; six
copies of it at once had not finished after 150 s with torch's default
threads, and took 12.1-12.9 s each with one thread.

One thread is also what bit-equality needs: the CPU convs split their sums
over threads, so a spawned rank and the process whose results it is held to
must run the same number of threads.

``OMP_NUM_THREADS`` is set when pytest loads this file, before any test
module imports torch, and overrides what the shell had: the policy belongs to
the suite.  Ranks spawned by ``torch.multiprocessing`` and command-line
subprocesses inherit it.  ``pytest_configure`` also sets torch's count, in
case a plugin imported torch first.  ``tests/test_torch_threads.py`` checks
all three.
"""

import os

os.environ["OMP_NUM_THREADS"] = "1"


def pytest_configure(config):
    import torch

    torch.set_num_threads(1)
