"""``BENCHMARK.json`` and the files it names, resolved by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration's ``file`` is the JSON the entry runs, and the
traffic mix is ``traffic/<traffic>.json``. A metric applies to a cell
when it lists the cell under ``workloads``, or lists no cells at all.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def _by_name(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: Dict, name: str) -> Dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: Dict, name: str) -> Dict:
    """The configuration entry, with the JSON of its ``file`` under ``spec``."""
    entry = _by_name(bench["configs"], name, "configuration")
    with open(ROOT / entry["file"]) as fh:
        return dict(entry, spec=json.load(fh))


def traffic(name: str) -> Dict:
    with open(HERE / "traffic" / f"{name}.json") as fh:
        return json.load(fh)


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if applies(m, cell)]


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["per_layer"] if applies(m, cell)]


def _module(folder: str, name: str):
    """``<folder>/<name>.py`` as a module (a name may hold ``.`` or ``-``)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no file {path.relative_to(ROOT)} for {name!r}")
    spec = importlib.util.spec_from_file_location(f"perfbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The per-layer metric's reader: ``metrics/<name>.py``'s ``read(ctx)``."""
    return _module("metrics", metric).read


def entry(name: str):
    """The program's entry that a configuration names: ``entries/<name>.py``."""
    return _module("entries", name)
