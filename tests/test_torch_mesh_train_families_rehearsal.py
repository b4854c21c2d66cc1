"""``chip_smoke.py``'s ``mesh_train_families_path`` rehearsed on the host at
the reduced widths of ``MESH_TRAIN_FAMILIES_REHEARSAL``, in a module of
its own so that ``--dist loadfile`` does not queue it behind
``tests/test_torch_mesh_train_families.py``'s ranks."""
from __future__ import annotations

import subprocess
import sys
import textwrap

from test_torch_mesh_train_families import HERE, NICE, SRC, TIMEOUT

_REHEARSAL = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import chip_smoke as cs
import torch
import repro_torch.core as core
from repro_torch.kernels import _build as build
if __name__ == "__main__":
    cs.phase_mesh_train_families_path(torch, core, build, device="cpu", spec=cs.MESH_TRAIN_FAMILIES_REHEARSAL)
"""


def test_chip_smoke_mesh_train_families_path_rehearses_on_the_cpu():
    """``chip_smoke.py``'s ``mesh_train_families_path`` at the reduced
    widths on the host: the float32 steps on the meshes against one
    process, the bf16 walls, the world of 3 ranks, no kernel launched."""
    script = textwrap.dedent(_REHEARSAL.format(src=str(SRC), root=str(HERE.parent)))
    r = subprocess.run(NICE + [sys.executable, "-c", script], capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith('{"phase": "mesh_train_families_path"')]
    assert len(lines) == 1 and '"ok": true' in lines[0]


