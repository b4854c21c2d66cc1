"""The second half of ``tests/test_torch_mesh_train_families.py``'s cases,
in a module of its own so that ``--dist loadfile`` runs the two on two
workers: the train steps held to the port's one process or to the
reference's dense steps (no sequence parallelism, a sequence model 4 does
not divide, uneven widths, EP, FFN-split experts past 512 records), the
cases served under ``dp`` and at an uneven ``d_model``, ``launch.train``
on the mesh, and ``init_all``'s copy of the given tensors. The machinery,
the cases and what must hold are that module's.
"""
from __future__ import annotations

import pytest

import test_torch_mesh_train_families as base


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return base.run_cases(tmp_path_factory, base.OTHER_TRAIN, list(base.SERVE), extras=True)


@pytest.mark.parametrize("case", base.OTHER_TRAIN)
def test_mesh_train_step(runs, case):
    base.check_train_step(runs, case)


@pytest.mark.parametrize("case", list(base.SERVE))
def test_mesh_prefill_and_decode(runs, case):
    base.check_prefill_and_decode(runs, case)


@pytest.mark.parametrize("case", list(base.SERVE))
def test_mesh_cache_placed_by_the_sanitized_cache_specs(runs, case):
    base.check_cache_specs(runs, case)


def test_init_all_on_a_mesh_copies_the_given_tensors(runs):
    assert runs["port"]["given_tensors_kept"]


def test_launch_train_on_the_mesh_equals_one_process(runs):
    base.check_launch_train(runs)
