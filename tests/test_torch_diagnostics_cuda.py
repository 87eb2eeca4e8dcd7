"""The port's diagnostics on a card: the CUDA versions, the memory query
and the printed report.

These tests need an NVIDIA GPU; elsewhere they skip.  Run them on the card
with ``python -m pytest --noconftest tests/test_torch_diagnostics_cuda.py``
(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use and the card's machine need not have).
"""

import pytest
import torch

import minkowskiengine_tpu_torch as MT
from minkowskiengine_tpu_torch.diagnostics import _version_int

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def test_versions(dev):
    assert MT.is_cuda_available() is True
    assert MT.cuda_version() == _version_int(torch.version.cuda)
    # the runtime that torch loaded is at least as new as the toolkit's major version
    assert MT.cudart_version() // 1000 >= MT.cuda_version() // 1000 > 0


def test_memory_info(dev):
    torch.cuda.empty_cache()  # so that the allocation below reaches cudaMalloc
    free, total = MT.get_gpu_memory_info()
    assert 0 < free <= total
    x = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    free_after, total_after = MT.get_gpu_memory_info(dev)
    assert total_after == total and free_after <= free - x.numel() // 2


def test_print_diagnostics_names_the_card(dev, capsys):
    MT.print_diagnostics()
    text = capsys.readouterr().out
    assert "is_cuda_available: True" in text
    assert f"cuda:0 {torch.cuda.get_device_name(0)}" in text
    assert f"cudart_version: {MT.cudart_version()}" in text
    assert "memory free" in text and "native host engine: loaded" in text
