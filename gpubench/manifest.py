"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Its configuration's file is the one the manifest's ``configs`` entry gives;
the mix is ``gpubench/traffic/<traffic>.json``; each per-layer metric is
read by ``gpubench/metrics/<name>.py`` (its ``read(ctx)``); the
configuration's plain reference is the module its file names under
``reference`` (``gpubench/reference/<reference>.py``). A later cell adds
files and entries; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(__file__).resolve().parent


def load(root: Path = ROOT) -> Dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _entry(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def metric_reader(name: str, pkg: Path = PKG) -> Callable:
    """``gpubench/metrics/<name>.py``'s ``read``."""
    path = Path(pkg) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(config: Dict):
    return importlib.import_module(f"gpubench.reference.{config['reference']}")


def cell(name: str, root: Path = ROOT, manifest: Dict = None) -> Dict:
    """Everything one run of cell ``name`` reads: its entry, its
    configuration and traffic files, its end-to-end metrics and the readers
    of its per-layer metrics (those that list the cell, or list no cells)."""
    root = Path(root)
    man = manifest if manifest is not None else load(root)
    wl = _entry(man["workloads"], name, "workload")
    cfg_entry = _entry(man["configs"], wl["config"], "config")
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "gpubench" / "traffic" / f"{wl['traffic']}.json").read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    return {"workload": wl, "config_entry": cfg_entry, "config": config, "traffic": traffic,
            "end_to_end": [m for m in man["end_to_end"] if mine(m)],
            "per_layer": [m for m in man["per_layer"] if mine(m)],
            "root": root}
