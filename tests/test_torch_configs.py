"""The port's ``configs`` against the JAX package's: every field, the
reduced variants, the derived counts and the skip rules, for all ten
architectures and the four shapes."""
from __future__ import annotations

import dataclasses

import pytest

from repro_torch.configs import ALL, SHAPES, all_archs, get_arch
from test_torch_harness import ref_lm

ARCHS = sorted(all_archs())


def derived(cfg) -> dict:
    """Everything a config computes from its fields."""
    return dict(
        fields=dataclasses.asdict(cfg),
        hd=cfg.hd,
        sub_quadratic=cfg.sub_quadratic,
        has_decoder=cfg.has_decoder,
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
        runnable={name: cfg.runnable(shape) for name, shape in sorted(SHAPES.items())},
        attn_layers=[cfg.is_attn_layer(i) for i in range(cfg.n_layers)],
        moe_layers=[cfg.is_moe_layer(i) for i in range(cfg.n_layers)],
    )


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    ref = ref_lm().configs.get_arch(arch)
    cfg = get_arch(arch)
    assert derived(cfg) == derived(ref)
    assert derived(cfg.reduced()) == derived(ref.reduced())
    # the reference's runnable() takes its own ShapeConfig: same answers
    rshapes = ref_lm().configs.SHAPES
    assert {n: cfg.runnable(s) for n, s in SHAPES.items()} == {n: ref.runnable(s) for n, s in rshapes.items()}


def test_shapes_and_registry_equal_reference():
    r = ref_lm().configs
    assert {n: dataclasses.asdict(s) for n, s in SHAPES.items()} == {
        n: dataclasses.asdict(s) for n, s in r.SHAPES.items()}
    assert [c.name for c in ALL] == [c.name for c in r.ALL]
    assert sorted(all_archs()) == sorted(r.all_archs())
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
