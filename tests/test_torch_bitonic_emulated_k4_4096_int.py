"""K4's CUDA source on the CPU against the plain network: width 4096 (one CTA a row, two wide stages), int32 and uint32 keys
(``test_torch_bitonic_emulated.py`` says how the source runs here).
Tolerance: exact bytes."""
from __future__ import annotations

import pytest
import torch

from test_torch_bitonic_emulated import build_emulated, check_k4

VALUE_DTYPES = (torch.int16, torch.int32, torch.int64)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build_emulated(tmp_path_factory)


@pytest.mark.parametrize("width", (4096,))
@pytest.mark.parametrize("value_dtype", VALUE_DTYPES)
@pytest.mark.parametrize("dtype", (torch.int32, torch.uint32))
def test_emulated_k4_matches_network(lib, dtype, value_dtype, width):
    check_k4(lib, dtype, value_dtype, width)
