"""No process of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the program. Names are compared by their
top-level part whole: ``repro_torch`` begins with ``repro``."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from perfbench import run

ROOT = Path(__file__).resolve().parents[2]
PERFBENCH = ROOT / "perfbench"

PROBE = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_forbidden_check_compares_whole_top_level_names():
    assert run.forbidden_modules(["repro_torch", "repro_torch.core", "reprox", "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_no_jax_and_no_reference_package():
    body = (
        "from perfbench import run, control, devtrace\n"
        "import glob, os\n"
        "from perfbench import manifest\n"
        "[manifest.reader(os.path.basename(p)[:-3]) for p in glob.glob(os.path.join(%r, 'metrics', '*.py'))]\n"
        "r = run.run_cell('det-keys-u-2e27', 2**31 + 9, 0.05, True, device='cpu', sizes={'p': 8, 'n': 1024})\n"
        "assert r['correct'], r\n" % str(PERFBENCH)
    )
    mods = loaded(body)
    assert "repro_torch" in mods and "perfbench" in mods
    assert run.forbidden_modules(mods) == []


def test_the_reference_loads_nothing_of_the_program():
    mods = loaded("from perfbench import reference, roofline, traffic, measure")
    assert not mods & ({"repro_torch"} | set(run.FORBIDDEN))


def test_the_yardstick_imports_no_program_module():
    for name in ("reference.py", "roofline.py", "traffic.py", "measure.py", "devtrace.py", "manifest.py"):
        tree = ast.parse((PERFBENCH / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & ({"repro_torch"} | set(run.FORBIDDEN)), (name, tops)


def test_no_run_without_the_program(tmp_path):
    """A checkout of only BENCHMARK.json and perfbench/ runs nothing."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PERFBENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from perfbench import run; "
            "print(run.run_cell('det-keys-u-2e27', 1, 0.05, False, device='cpu', sizes={'p': 8, 'n': 1024}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=240)
    assert out.returncode != 0 and "correct" not in out.stdout


def test_the_command_line_refuses_a_machine_without_the_card(capsys):
    import torch

    if torch.cuda.is_available():
        return  # the card's own runs cover this machine
    assert run.main(["--workload", "det-keys-u-2e27", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
