"""Every module of the port imports on its own, in a fresh interpreter,
and imports neither JAX nor the JAX package.

A module that only imports after some other module of the package (a
circular import that the usual import order hides) fails here, and so
does one that leaves ``jax`` or ``repro`` (or a submodule of either) in
``sys.modules``. The modules are found by walking the package; one
subprocess imports each in a fresh interpreter of its own, four at a
time, and reports the failures.
"""
from __future__ import annotations

import os
import subprocess
import sys

from test_torch_harness import SRC

_EACH_ALONE = r"""
import pkgutil, subprocess, sys
from concurrent.futures import ThreadPoolExecutor
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]

CHECK = '''
import sys
import {name}
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
sys.exit("imports " + ", ".join(bad[:5]) if bad else 0)
'''

def alone(name):
    p = subprocess.run([sys.executable, "-c", CHECK.format(name=name)], capture_output=True, text=True,
                       timeout=120)
    return name + ": " + (p.stderr.strip().splitlines() or ["?"])[-1] if p.returncode else None

with ThreadPoolExecutor(4) as pool:  # four interpreters at a time
    bad = [b for b in pool.map(alone, names) if b]
print(len(names), "modules")
print("\n".join(bad))
sys.exit(1 if bad else 0)
"""


def test_every_module_imports_alone():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _EACH_ALONE], env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 38, proc.stdout
