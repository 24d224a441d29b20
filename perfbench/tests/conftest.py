"""The benchmark's CPU tests: one intra-op thread a worker (the suite runs
under several workers), and a tiny cell built from new files in a
temporary directory."""
import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from perfbench.tests.tiny import make_tiny

    return make_tiny(tmp_path_factory.mktemp("tiny"))
