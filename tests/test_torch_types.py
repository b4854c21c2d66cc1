"""The port's SortConfig arithmetic, capacity ladder and datagen equal the
JAX package's over a grid of configurations."""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

from repro_torch.core import SortConfig, config_from_reference, datagen
from test_torch_harness import config_fields, reference

_PROPS = ("n", "omega_eff", "r", "s", "segment_len", "n_max", "pair_cap")

_GRID = [
    dict(p=p, n_per_proc=n_p, algorithm=alg, **extra)
    for p, n_p, alg, extra in itertools.product(
        (1, 4, 8, 128),
        (1, 100, 512, 8192, 65536),
        ("det", "iran", "ran", "bitonic"),
        (
            dict(),
            dict(pair_capacity="whp"),
            dict(pair_capacity="whp", capacity_factor=2.0, omega=3.0),
            dict(pair_capacity="planned", pair_cap_override=77),
            dict(routing="allgather", pair_capacity="whp"),
            dict(routing="allgather", n_max_mode="full"),
            dict(route="radix", n_max_override=900, pad_align=16),
        ),
    )
]


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(SortConfig)}


@pytest.mark.parametrize("chunk", range(4))
def test_config_properties_and_ladder_match_reference(chunk):
    ref = reference()
    for kw in _GRID[chunk::4]:
        rcfg = ref.SortConfig(**kw)
        pcfg = config_from_reference(config_fields(rcfg))
        assert pcfg == SortConfig(**kw)
        for prop in _PROPS:
            assert getattr(pcfg, prop) == getattr(rcfg, prop), (kw, prop)
        rl, pl = rcfg.tier_ladder(), pcfg.tier_ladder()
        assert [t for t, _ in pl] == [t for t, _ in rl], kw
        for (_, rt), (_, pt) in zip(rl, pl):
            assert _fields(pt) == {k: v for k, v in config_fields(rt).items() if k in _fields(pt)}
            assert pt.n_max == rt.n_max and pt.pair_cap == rt.pair_cap


@pytest.mark.parametrize(
    "kw",
    [
        dict(p=6, n_per_proc=8),
        dict(p=4, n_per_proc=0),
        dict(p=4, n_per_proc=8, algorithm="odd"),
        dict(p=4, n_per_proc=8, merge="heap"),
        dict(p=4, n_per_proc=8, pair_capacity="planned"),
        dict(p=4, n_per_proc=8, route="radix", routing="allgather"),
        dict(p=4, n_per_proc=8, merge_backend="triton"),
    ],
)
def test_validate_rejects_what_the_reference_rejects(kw):
    ref = reference()
    with pytest.raises(ValueError):
        ref.SortConfig(**kw).validate()
    with pytest.raises(ValueError):
        SortConfig(**kw).validate()


def test_config_from_reference_refuses_host_handles():
    with pytest.raises(ValueError, match="obs"):
        config_from_reference(dict(p=4, n_per_proc=8, obs=object()))
    assert config_from_reference(dict(p=4, n_per_proc=8, obs=None, chaos=None)) == SortConfig(
        p=4, n_per_proc=8
    )


@pytest.mark.parametrize("name", sorted(datagen.DISTRIBUTIONS))
def test_datagen_matches_reference(name):
    ref = reference()
    for p, n_p, seed in ((4, 100, 0), (8, 512, 3)):
        want = ref.datagen.generate(name, p, n_p, seed)
        got = datagen.generate(name, p, n_p, seed)
        assert got.dtype == want.dtype and np.array_equal(got, want)
