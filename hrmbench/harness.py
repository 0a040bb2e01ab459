"""Cells, metrics and the result line, found by name in ``BENCHMARK.json``.

A cell ``<config>.<mix>`` is the entry of ``BENCHMARK.json``'s
``workloads``; ``workloads/<cell>.json`` holds its serving settings (the
driver ``kind``, the HRM design point, slots, limits), ``configs/`` its
model configuration, ``traffic/`` its mix. A metric ``<name>`` is read
from a run's record by ``metrics/<name>.py``'s ``read(rec)``, which
returns None when the record holds nothing for it.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Context:
    """What a driver is given."""
    name: str
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float
    device_kind: str = ""
    control: bool = False


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    for w in benchmark()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(name: str):
    """(workload entry, cell settings, configuration, mix) of a cell."""
    w = workload(name)
    return (w, load_json(BENCH / "workloads" / f"{name}.json"),
            load_json(BENCH / "configs" / f"{w['config']}.json"),
            load_json(BENCH / "traffic" / f"{w['traffic']}.json"))


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "hrmbench._loaded." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str) -> ModuleType:
    return importlib.import_module(f"hrmbench.drivers.{kind}")


def metrics_of(name: str, traced: bool) -> List[dict]:
    """The metrics a run of cell ``name`` reports: the end-to-end ones, or
    with ``traced`` the per-layer ones, that list the cell or no cell."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in benchmark()[key]
            if "workloads" not in m or name in m["workloads"]]


def read_metrics(name: str, traced: bool, rec: dict) -> Dict[str, dict]:
    out = {}
    for m in metrics_of(name, traced):
        v = _module(BENCH / "metrics" / f"{m['name']}.py").read(rec)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def check_rows(rec: dict) -> List[dict]:
    rows = []
    for name, value, limit, kind in rec["checks"]:
        ok = value <= limit if kind == "max" else value >= limit
        rows.append({"name": name, "value": value, "limit": limit,
                     "kind": kind, "ok": bool(ok)})
    return rows


def result(rec: dict, metrics: Dict[str, dict], device: dict,
           checks: List[dict], breakdown: Optional[dict]) -> dict:
    out = {"correct": all(c["ok"] for c in checks),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"],
                                 "must_be": "at_most" if c["kind"] == "max"
                                 else "at_least"} for c in checks}
    return out
