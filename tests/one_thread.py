"""A module fixture for the port's test files: torch on one thread, in the
test process and in the subprocesses its tests start (OMP_NUM_THREADS=1).

The suite runs in several worker processes at once, and each one's torch
thread pool spans every core: the pools then wait on each other. Measured
on an 8-core host with 6 workers, the port's files took 585 s with torch's
default threads and 330 s with one; the wide packet's file 194 s against
25 s. Integer work gives the same bits on any number of threads."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        torch.set_num_threads(1)
        try:
            yield
        finally:
            torch.set_num_threads(threads)
