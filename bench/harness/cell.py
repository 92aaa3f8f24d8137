"""One cell of ``BENCHMARK.json`` and the files it is made of, found by
name: the configuration's file (its ``file`` entry), the traffic mix
``traffic/<traffic>.json``, the serving mode ``modes/<mode>.py`` the mix
names, the reference ``reference/<family>.py``, each metric's reader
``metrics/<metric>.py`` and the limits ``checks/<workload>.json``.
Nothing here names a cell, a configuration or a metric: a new one is new
files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark from its file, under a name of its own."""
    rel = path.resolve().relative_to(BENCH)
    name = "bench_" + "_".join(rel.with_suffix("").parts)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]          # the configuration's file
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def conf(self) -> Dict[str, Any]:
        """The numbers the configuration runs with."""
        return self.config["config"]

    def mode(self) -> ModuleType:
        return load_module(BENCH / "modes" / f"{self.traffic['mode']}.py")

    def reference(self) -> ModuleType:
        return load_module(BENCH / "reference" / f"{self.conf['family']}.py")

    def program_config(self):
        """The program's config: its registered config with every number of
        the file in place; a field the file lacks or a key the program
        does not know raises."""
        from repro_torch.configs import get_config

        base = get_config(self.config["port_config"])
        fields = {f.name: f for f in dataclasses.fields(base)}
        nums = self.conf
        if set(nums) != set(fields):
            raise ValueError(f"{self.config['name']}: the file's numbers differ from the "
                             f"program's fields: missing {sorted(set(fields) - set(nums))}, "
                             f"unknown {sorted(set(nums) - set(fields))}")
        vals = {k: tuple(v) if isinstance(v, list) else v for k, v in nums.items()}
        return dataclasses.replace(base, **vals)


def reports(metric: Dict[str, Any], workload: str, e2e_names) -> bool:
    """Whether a per-layer metric is read in ``workload``."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in e2e_names


def load(workload: str, bench_json: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = load_json(bench_json)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_json.name}: {sorted(cells)}")
    w = cells[workload]
    conf_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if reports(m, workload, names)]
    return Cell(
        name=workload,
        workload=w,
        config=load_json(ROOT / conf_entry["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "checks" / f"{workload}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )
