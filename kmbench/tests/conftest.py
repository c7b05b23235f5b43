"""Shared pieces of the benchmark's CPU tests: a small form of each cell's
configuration (the harness's whole path, on the program's plain versions),
and the fixture that decides whether a card is there."""

import pytest

SMALL = {"img_size": [32, 32, 32], "f_maps": 8, "num_keypoints": 16, "max_train_keypoints": 8}


@pytest.fixture
def small():
    return dict(SMALL)


@pytest.fixture
def card():
    """The CUDA device, or a skip: tests marked ``gpu`` run on the card only."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "python -m pytest kmbench/tests -m gpu")
    return torch.device("cuda")
