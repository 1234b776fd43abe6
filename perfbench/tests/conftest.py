"""Fixtures of the benchmark's tests: a small CPU size of each cell, and
the card for the tests marked ``cuda``."""
from __future__ import annotations

from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

# a size a CPU test run holds: 1,280 training and 256 test images, 20
# participants of whom 4 train a round; the widths stay as configured
SMALL = {
    "cifar10_resnet18.as_local": {
        "dataset": {"train_size": 1280, "test_size": 256},
        "params": {"number_of_total_participants": 20, "no_models": 4,
                   "adversary_list": [1, 3, 5, 7]}},
    "tiny_resnet18.am_nolocal": {
        "dataset": {"train_size": 800, "test_size": 200, "image_size": 32},
        "arch": {"image_size": 32},
        "params": {"number_of_total_participants": 20, "no_models": 6,
                   "adversary_list": [1, 3, 5, 7],
                   "internal_poison_epochs": 2}},
}


@pytest.fixture
def cpu_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="session")
def small_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("perfbench_cache")


@pytest.fixture
def card():
    """The first CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
