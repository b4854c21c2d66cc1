"""The reference and its comparison: what it accepts and what it rejects."""
from __future__ import annotations

import pytest
import torch

from perfbench import reference


def tie_rich(n=4096, seed=0):
    g = torch.Generator().manual_seed(seed)
    keys = torch.randint(0, 64, (16, n // 16), generator=g, dtype=torch.int32)
    vals = torch.arange(n, dtype=torch.int32).reshape(keys.shape)
    return keys, vals


def test_a_correct_answer_passes():
    keys, vals = tie_rich()
    order = torch.argsort(keys.reshape(-1), stable=True)
    nums = reference.judge(keys.reshape(-1)[order], vals.reshape(-1)[order], keys, vals)
    assert nums == {"lost_keys": 0, "key_mismatches": 0, "payload_mismatches": 0}


def test_a_swapped_pair_is_rejected():
    keys, _ = tie_rich()
    out = torch.sort(keys.reshape(-1)).values.clone()
    i = int((out[1:] != out[:-1]).nonzero()[0])  # two different neighbours
    out[i], out[i + 1] = out[i + 1].clone(), out[i].clone()
    nums = reference.judge(out, None, keys, None)
    assert nums["key_mismatches"] == 2 and nums["lost_keys"] == 0


def test_a_payload_permuted_among_equal_keys_is_rejected():
    keys, vals = tie_rich()
    order = torch.argsort(keys.reshape(-1), stable=True)
    out_k, out_v = keys.reshape(-1)[order], vals.reshape(-1)[order].clone()
    assert out_k[0] == out_k[1]
    out_v[0], out_v[1] = out_v[1].clone(), out_v[0].clone()
    nums = reference.judge(out_k, out_v, keys, vals)
    assert nums["key_mismatches"] == 0 and nums["payload_mismatches"] == 2


def test_a_dropped_key_is_rejected():
    keys, _ = tie_rich()
    out = torch.sort(keys.reshape(-1)).values[:-1]
    nums = reference.judge(out, None, keys, None)
    assert nums["lost_keys"] == 1 and nums["key_mismatches"] >= 1


def test_a_missing_payload_is_rejected():
    keys, vals = tie_rich()
    nums = reference.judge(torch.sort(keys.reshape(-1)).values, None, keys, vals)
    assert nums["payload_mismatches"] == keys.numel()


@pytest.mark.parametrize("mode", ["int16", "unstable"])
def test_each_control_fails_on_ties(mode):
    """Keys in [0, 2^20): the top 16 bits tie within blocks of 65 536."""
    g = torch.Generator().manual_seed(1)
    keys = torch.randint(0, 2**20, (16, 512), generator=g, dtype=torch.int32)
    keys[:, ::4] = 7  # ties for the unstable control
    vals = torch.arange(keys.numel(), dtype=torch.int32).reshape(keys.shape)
    out_k, out_v = reference.control(keys, vals, mode, torch.Generator().manual_seed(2))
    nums = reference.judge(out_k, out_v, keys, vals)
    assert max(nums[k] - reference.LIMITS[k] for k in nums) > 0


def test_unknown_control_raises():
    keys, vals = tie_rich()
    with pytest.raises(ValueError):
        reference.control(keys, vals, "float8")
