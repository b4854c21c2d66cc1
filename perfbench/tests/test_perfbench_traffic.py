"""The generator: every distribution repeats per seed and has its shape."""
from __future__ import annotations

import pytest
import torch

from perfbench import traffic

SPECS = {
    "uniform": {"dist": "uniform", "low": 0, "high": 2**31 - 1},
    "zipf": {"dist": "zipf", "alpha": 1.5, "cap": 2**31 - 2},
    "dd": {"dist": "dd"},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_generator_repeats_per_seed(name):
    t = {"keys": SPECS[name]}
    a = traffic.make_pool(t, 8, 512, 2**31 + 5, "cpu")
    b = traffic.make_pool(t, 8, 512, 2**31 + 5, "cpu")
    c = traffic.make_pool(t, 8, 512, 7, "cpu")
    assert len(a) == traffic.POOL and all(x.shape == (8, 512) and x.dtype == torch.int32 for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    if name != "dd":  # [DD] is seedless
        assert not torch.equal(a[0], c[0])
        assert not torch.equal(a[0], a[1])


def test_uniform_range():
    x = traffic.make_keys(SPECS["uniform"], 4, 4096, torch.Generator().manual_seed(1), "cpu")
    assert int(x.min()) >= 0 and int(x.max()) < 2**31 - 1


def test_zipf_head_share():
    """About 1 / zeta(1.5) = 0.383 of Zipf(1.5) keys are 1."""
    x = traffic.make_keys(SPECS["zipf"], 16, 8192, torch.Generator().manual_seed(3), "cpu")
    assert int(x.min()) >= 1 and int(x.max()) <= 2**31 - 2
    assert abs(float((x == 1).float().mean()) - 0.3828) < 0.01


def test_dd_matches_the_ports_datagen():
    from repro_torch.core import datagen

    want = torch.from_numpy(datagen.deterministic_duplicates(16, 256))
    assert torch.equal(traffic.make_keys(SPECS["dd"], 16, 256, None, "cpu"), want)
