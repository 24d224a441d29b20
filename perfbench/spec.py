"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's file is the path its ``configs`` entry gives;
the mix is ``traffic/<traffic>.json``, the runner it names
``runners/<runner>.py``, the comparison's limits ``limits/<cell>.json``
and each metric's reader ``metrics/<metric>.py``, each looked up in the
search directories in order (this package's own directory by default).
A mix holds the keys its runner reads (``MIX_KEYS``), ``runner`` and an
optional ``about``, and no other: a key no runner reads is refused, not
ignored.  A later cell, mix, runner or metric is new files and new
entries: no existing file changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

__all__ = ["HERE", "Spec", "Cell", "Metric"]

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    read: object  # reader(run) -> float | None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    metrics: dict  # 'end_to_end' / 'per_layer' -> [Metric]
    runner: object  # the module runners/<traffic["runner"]>.py


class Spec:
    def __init__(self, bench_json: Path, search: tuple = (HERE,)):
        self.path = Path(bench_json)
        self.root = self.path.parent
        self.search = tuple(Path(s) for s in search)
        self.data = json.loads(self.path.read_text())

    def _find(self, sub: str, name: str, suffix: str) -> Path:
        for d in self.search:
            p = d / sub / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {sub}/{name}{suffix} in {[str(d) for d in self.search]}")

    @staticmethod
    def _load(path: Path, module: str):
        if module in sys.modules:
            return sys.modules[module]
        spec = importlib.util.spec_from_file_location(module, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[module] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[module]
            raise
        return mod

    def _load_reader(self, name: str):
        return self._load(self._find("metrics", name, ".py"),
                          "perfbench_metric_" + name.replace(".", "_")).read

    def _load_runner(self, mix_name: str, mix: dict):
        if "runner" not in mix:
            raise KeyError(f"traffic/{mix_name}.json names no runner")
        name = mix["runner"]
        runner = self._load(self._find("runners", name, ".py"), f"perfbench.runners.{name}")
        keys = set(mix) - {"runner", "about"}
        if keys != set(runner.MIX_KEYS):
            want = set(runner.MIX_KEYS)
            raise ValueError(f"traffic/{mix_name}.json: runner {name!r} does not read "
                             f"{sorted(keys - want)} and needs {sorted(want - keys)}")
        return runner

    def cell(self, name: str) -> Cell:
        cells = [w for w in self.data["workloads"] if w["name"] == name]
        if len(cells) != 1:
            raise KeyError(f"workload {name!r} is not in {self.path}")
        w = cells[0]
        conf = [c for c in self.data["configs"] if c["name"] == w["config"]]
        if len(conf) != 1:
            raise KeyError(f"configuration {w['config']!r} is not in {self.path}")
        config = json.loads((self.root / conf[0]["file"]).read_text())
        traffic = json.loads(self._find("traffic", w["traffic"], ".json").read_text())
        runner = self._load_runner(w["traffic"], traffic)
        limits = json.loads(self._find("limits", name, ".json").read_text())
        metrics = {}
        for kind in ("end_to_end", "per_layer"):
            metrics[kind] = [
                Metric(m["name"], m["unit"], self._load_reader(m["name"]))
                for m in self.data[kind] if "workloads" not in m or name in m["workloads"]]
        return Cell(name, int(w["chips"]), w["config"], config, w["traffic"], traffic, limits,
                    metrics, runner)
