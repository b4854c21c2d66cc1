"""The one-device dry-run's cells of the full tinyllama-1.1b (22 layers,
d_model 2048), traced on ``meta`` tensors at every shape the reference
runs: the train step at 256 x 4096 tokens, the prefill of 32 x 32 768
(22 x 528 attention chunk pairs: the longest trace, ~1 min on the CPU),
the decode step on a 32 768-position cache of 128 rows; long_500k is
skipped for the reference's reason. In a file of its own so that the
trace runs beside ``test_torch_dryrun.py``'s cells."""
from __future__ import annotations

import pytest

from repro_torch.configs import SHAPES
from test_torch_dryrun import test_lower_cell_at_full_width as check_cell


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_lower_cell_at_full_width(shape):
    check_cell("tinyllama-1.1b", shape)
