import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs an NVIDIA GPU; skipped where CUDA is unavailable")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# a small cell for the CPU: published structure, narrow widths, few rays
SMALL = {"config": {"model": {"W": 32, "inst_W": 16, "N_samples": 8, "N_importance": 8}},
         "traffic": {"batch": 64, "pool_rays": 1024, "views": 2, "img_wh": [32, 24],
                     "warmup_steps": 1, "chunk": 256}}
