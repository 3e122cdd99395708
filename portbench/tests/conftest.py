"""Tests of the benchmark itself: on the CPU at tiny sizes, and on the card
where a fixture finds one (``card``), never deciding at import time."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's readings exist only on the card")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _port_config():
    from strided_tpu_torch.config import get_config, set_config

    saved = get_config()
    yield
    set_config(**{f: getattr(saved, f) for f in saved.__dataclass_fields__})
