"""The MoE's mesh paths (``moe_ep``, ``moe_ep_decode``, ``moe_tp_sharded``,
``moe_ep_counts``, ``moe_ep_safe``) on a (data=2, model=4) mesh of 8 gloo
ranks of the host, against the JAX package's on 8 host devices, as its
``tests/test_distributed.py::test_moe_ep_sharded_matches_dense_reference``
sets them up: the reduced granite with 8 experts, top-2, d_model 32,
d_ff 16, the reference's ``init_moe(key(0))`` weights carried across.

The reference runs in a subprocess with
``--xla_force_host_platform_device_count=8`` and writes its weights,
inputs and outputs; then ``python tests/test_torch_moe_ep.py DIR`` starts
the 8 ranks, each of which takes its blocks (``token_block``,
``expert_block``, ``ffn_block``) and returns its block of the output.
float32 outputs are held at 1e-4 of the largest |y|, bfloat16 at the
reference test's 3e-2; overflow flags, counts, tiers and ``TierStats``
exactly; the aux terms at 1e-5 (float32) and 1e-4 (bfloat16) relative.

``moe_tp_sharded`` shards its tokens over the data axes only in the port
(every model shard must hold the same tokens for the row-parallel sum to
be one token's): on a sequence the model axis does not divide, the JAX
package does the same, and the two are held to each other; on one it
divides, the JAX package splits the sequence too and sums the partial
outputs of different tokens, so the port is held to the dense
evaluation there.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
DTYPES = ("float32", "bfloat16")
MESH = (2, 4)
E, K, D, FF = 8, 2, 32, 16
#: case -> (global token shape, capacity factor)
SHAPES = {"ep_cf4": ((4, 16, D), 4.0), "ep_cf1": ((4, 16, D), 1.0), "counts": ((4, 16, D), None),
          "decode": ((4, 3, D), None), "tp": ((4, 6, D), 1.25), "tp_seq": ((4, 16, D), 1.25),
          "safe_biased": ((4, 16, D), 1.25), "safe_radix": ((4, 16, D), None)}
CASES = ["ep_cf4", "ep_cf1", "counts", "decode", "tp", "safe_biased", "safe_radix"]
TIMEOUT = 240


def tokens(case: str) -> np.ndarray:
    shape, _ = SHAPES[case]
    x = np.random.default_rng(len(case)).standard_normal(shape).astype(np.float32)
    # the biased cases: a shared offset in every token, and the router's
    # columns of model shard 0's experts leaning on it, so most records go
    # to that shard
    return x + 1.0 if case.startswith("safe") else x


def bias_router(w: np.ndarray) -> np.ndarray:
    w = w.copy()
    w[:, : E // MESH[1]] += 0.2
    return w


# ------------------------------------------------------------------ ranks
def _rank(rank: int, n: int, root: str) -> dict:
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import TierStats
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    mesh = make_mesh(MESH, ("data", "model"), "cpu")
    mi = moe.MoEMeshInfo(mesh=mesh, model_axis="model", data_axes=("data",))
    out = {}
    for dtype in DTYPES:
        data = np.load(os.path.join(root, f"{dtype}.npz"))
        cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(), moe_experts=E, moe_top_k=K, d_model=D, d_ff=FF, dtype=dtype)
        dt = getattr(torch, dtype)
        full = {k: torch.from_numpy(data[k]).to(torch.float32 if k == "router" else dt)
                for k in ("router", "w_gate", "w_up", "w_down")}
        for case in (*CASES, "tp_seq"):
            x = torch.from_numpy(data[f"x_{case}"]).to(dt)
            cf = SHAPES[case][1]
            seq = case not in ("decode", "tp", "tp_seq")
            params = dict(full)
            if case.startswith("safe"):
                params["router"] = torch.from_numpy(bias_router(data["router"]))
            params = moe.ffn_block(params, mi) if case.startswith("tp") else moe.expert_block(params, mi)
            xl = moe.token_block(x, mi, seq_shard=seq)
            stats = None
            if case.startswith("ep"):
                y, aux = moe.moe_ep(params, xl, cfg, mi, capacity_factor=cf)
            elif case == "decode":
                y, aux = moe.moe_ep_decode(params, xl, cfg, mi)
            elif case.startswith("tp"):
                y, aux = moe.moe_tp_sharded(params, xl, cfg, mi, capacity_factor=cf)
            elif case == "counts":
                out[(dtype, case)] = dict(count=int(moe.moe_ep_counts(params, xl, cfg, mi)))
                continue
            else:
                stats = TierStats()
                y, aux, _ = moe.moe_ep_safe(params, xl, cfg, mi, capacity_factor=cf or 1.25, stats=stats,
                                            route="radix" if case == "safe_radix" else "sample")
            out[(dtype, case)] = dict(
                y=y.float(), slices=moe.token_slices(x.shape, mi, seq), overflow=bool(aux["overflow"]),
                aux={k: float(v) for k, v in aux.items() if k != "overflow"},
                row=None if stats is None else stats.as_row())
    return out


def _main(root: str) -> None:
    from repro_torch.launch.mesh import spawn

    torch.save(spawn(_rank, MESH[0] * MESH[1], device="cpu", args=(root,)), os.path.join(root, "ranks.pt"))


# -------------------------------------------------------------- reference
_REFERENCE = """
import sys
sys.path[:0] = [{src!r}, {tests!r}]
import dataclasses
import numpy as np
from test_torch_harness import reference
reference()
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_arch
from repro.core import TierStats
from repro.models import moe
from test_torch_moe_ep import CASES, D, DTYPES, E, FF, K, MESH, SHAPES, bias_router, tokens
mesh = Mesh(np.array(jax.devices()[:8]).reshape(MESH), ("data", "model"))
mi = moe.MoEMeshInfo(mesh=mesh, model_axis="model", data_axes=("data",))
ladder = {{}}
for cf in (0.5, 1.0, 1.25, 2.0, 4.0):
    for p in (1, 2, 4, 8, 16):
        ladder[f"ladder_{{cf}}_{{p}}"] = np.array([[c for _, c in moe.moe_capacity_ladder(cf, p)]])
        ladder[f"tiers_{{cf}}_{{p}}"] = np.array([t for t, _ in moe.moe_capacity_ladder(cf, p)])
np.savez({root!r} + "/ladder.npz", **ladder)
for dtype in DTYPES:
    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(), moe_experts=E, moe_top_k=K,
                              d_model=D, d_ff=FF, dtype=dtype)
    lp = jax.tree.map(lambda a: a[0], moe.init_moe(jax.random.key(0), cfg, 1))
    out = {{k: np.asarray(v.astype(jnp.float32)) for k, v in lp.items()}}
    for case in (*CASES, "tp_seq"):
        x = jnp.asarray(tokens(case)).astype(cfg.dtype)
        out[f"x_{{case}}"] = np.asarray(x.astype(jnp.float32))
        cf = SHAPES[case][1]
        params = dict(lp)
        if case.startswith("safe"):
            params["router"] = jnp.asarray(bias_router(np.asarray(lp["router"])))
        # the dense evaluation, every expert on every token
        def dense_fn(params, x):
            x2d = x.reshape(-1, D)
            probs, experts, _ = moe._router(x2d, params["router"], K)
            dense = jnp.zeros_like(x2d)
            for e in range(E):
                w = (probs * (experts == e)).sum(-1).astype(x.dtype)
                dense += w[:, None] * moe._expert_ffn(x2d, params["w_gate"][e], params["w_up"][e], params["w_down"][e])
            return dense.reshape(x.shape)
        out[f"dense_{{case}}"] = np.asarray(jax.jit(dense_fn)(params, x).astype(jnp.float32))
        if case == "counts":
            out["count_counts"] = np.asarray(jax.jit(lambda p, x: moe.moe_ep_counts(p, x, cfg, mi))(params, x))
            continue
        if case.startswith("ep"):
            y, aux = jax.jit(lambda p, x: moe.moe_ep(p, x, cfg, mi, capacity_factor=cf))(params, x)
        elif case == "decode":
            y, aux = jax.jit(lambda p, x: moe.moe_ep_decode(p, x, cfg, mi))(params, x)
        elif case.startswith("tp"):
            y, aux = jax.jit(lambda p, x: moe.moe_tp_sharded(p, x, cfg, mi, capacity_factor=cf))(params, x)
        else:
            st = TierStats()
            y, aux, _ = moe.moe_ep_safe(params, x, cfg, mi, capacity_factor=cf or 1.25, stats=st,
                                        route="radix" if case == "safe_radix" else "sample")
            out[f"row_{{case}}"] = np.array(sorted(st.as_row().items()), dtype=object)
        out[f"y_{{case}}"] = np.asarray(y.astype(jnp.float32))
        out[f"overflow_{{case}}"] = np.asarray(aux["overflow"])
        for k in ("lb_loss", "z_loss"):
            out[f"{{k}}_{{case}}"] = np.asarray(aux[k])
    np.savez({root!r} + f"/{{dtype}}.npz", **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("moe_ep"))
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{HERE}")
    refenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    script = textwrap.dedent(_REFERENCE.format(src=str(SRC), tests=str(HERE), root=root))
    r = subprocess.run([sys.executable, "-c", script], env=refenv, capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, f"reference failed:\n{r.stderr[-4000:]}"
    r = subprocess.run([sys.executable, str(Path(__file__)), root], env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, f"ranks failed:\n{r.stdout[-2000:]}{r.stderr[-4000:]}"
    ranks = torch.load(os.path.join(root, "ranks.pt"), weights_only=False)
    return dict(ranks=ranks, ladder=np.load(os.path.join(root, "ladder.npz")),
                ref={d: np.load(os.path.join(root, f"{d}.npz"), allow_pickle=True) for d in DTYPES})


def assembled(ranks, dtype: str, case: str) -> np.ndarray:
    """The global output from every rank's block; replicas must agree."""
    y = np.full(SHAPES[case][0], np.nan, np.float32)
    for r in ranks:
        got = r[(dtype, case)]
        bs, ss = got["slices"]
        block = got["y"].numpy()
        seen = y[bs, ss]
        assert np.isnan(seen).all() or seen.tobytes() == block.tobytes(), f"{case}: model replicas disagree"
        y[bs, ss] = block
    assert not np.isnan(y).any()
    return y


def assert_close(got: np.ndarray, want: np.ndarray, dtype: str, what: str) -> None:
    if dtype == "float32":
        tol = 1e-4 * float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= tol, f"{what}: max error {err} above {tol}"
    else:
        np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2, err_msg=what)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_mesh_path_equals_reference(runs, dtype, case):
    ranks, ref = runs["ranks"], runs["ref"][dtype]
    if case == "counts":
        got = {r[(dtype, case)]["count"] for r in ranks}
        assert got == {int(ref["count_counts"])}
        return
    y = assembled(ranks, dtype, case)
    assert_close(y, ref[f"y_{case}"], dtype, f"{case} against the reference")
    for r in ranks:
        got = r[(dtype, case)]
        assert got["overflow"] == bool(ref[f"overflow_{case}"]), case
        for k in ("lb_loss", "z_loss"):
            np.testing.assert_allclose(got["aux"][k], float(ref[f"{k}_{case}"]),
                                       rtol=1e-5 if dtype == "float32" else 1e-4, err_msg=k)
        if case.startswith("safe"):
            assert sorted(got["row"].items()) == [tuple(t) for t in ref[f"row_{case}"]], case
    if case == "ep_cf4" or case.startswith("safe"):
        assert not ranks[0][(dtype, case)]["overflow"]
        assert_close(y, ref[f"dense_{case}"], dtype, f"{case} against the dense evaluation")
    if case == "safe_biased":
        row = ranks[0][(dtype, case)]["row"]
        assert row["retries"] >= 1 and row.get("ok_full") == 1, row  # climbed past whp to full
    if case == "ep_cf1":
        assert ranks[0][(dtype, case)]["overflow"], "the case was meant to drop records"


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_tp_sharded_on_a_split_sequence_equals_dense(runs, dtype):
    ref = runs["ref"][dtype]
    y = assembled(runs["ranks"], dtype, "tp_seq")
    assert_close(y, ref["dense_tp_seq"], dtype, "moe_tp_sharded against the dense evaluation")
    # the JAX package's own output here sums the partial outputs of
    # different tokens (its model shards hold different tokens)
    assert float(np.abs(ref["y_tp_seq"] - ref["dense_tp_seq"]).max()) > 0.1 * float(np.abs(ref["dense_tp_seq"]).max())


@pytest.mark.parametrize("cf", (0.5, 1.0, 1.25, 2.0, 4.0))
def test_moe_capacity_ladder_equals_reference(runs, cf):
    from repro_torch.models.moe import moe_capacity_ladder

    for p in (1, 2, 4, 8, 16):
        got = moe_capacity_ladder(cf, p)
        assert [t for t, _ in got] == list(runs["ladder"][f"tiers_{cf}_{p}"])
        assert [c for _, c in got] == list(runs["ladder"][f"ladder_{cf}_{p}"][0])


if __name__ == "__main__":
    _main(sys.argv[1])
