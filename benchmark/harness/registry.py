"""Finds the files of a cell by the names in ``BENCHMARK.json``.

    configs/<config>.json       sizes, serving settings, weight route,
                                reference
    weights/<route>.py          builds the program's parameters
    reference/<reference>.py    the plain forward that judges the outputs
    traffic/<traffic>.json      a traffic mix, read by harness.traffic
    cells/<workload>.json       what the cell compares, and the limits
    metrics/<metric>.py         one per-layer metric, ``read(view)``

A later change adds a configuration, a mix, a cell or a metric by adding
files and ``BENCHMARK.json`` entries; nothing here names one of them.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG_DIR)


class Registry:
    """The benchmark's files under ``pkg_dir`` and its ``BENCHMARK.json``
    under ``root``.  A temporary copy of the tree gives its own paths."""

    def __init__(self, root: str = ROOT, pkg_dir: str = PKG_DIR,
                 package: str = "benchmark"):
        self.root = root
        self.pkg_dir = pkg_dir
        self.package = package

    def _json(self, *parts: str) -> Any:
        path = os.path.join(self.pkg_dir, *parts)
        with open(path) as fh:
            return json.load(fh)

    def bench(self) -> Dict[str, Any]:
        with open(os.path.join(self.root, "BENCHMARK.json")) as fh:
            return json.load(fh)

    def workload(self, name: str) -> Dict[str, Any]:
        for w in self.bench()["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict[str, Any]:
        return self._json("configs", f"{name}.json")

    def traffic(self, name: str) -> Dict[str, Any]:
        return self._json("traffic", f"{name}.json")

    def cell(self, name: str) -> Dict[str, Any]:
        return self._json("cells", f"{name}.json")

    def module(self, kind: str, name: str):
        """``<package>.<kind>.<name>``: a weight route, a reference or a
        metric reader (file names may hold '-' or '.', so by path)."""
        path = os.path.join(self.pkg_dir, kind, f"{name}.py")
        stem = name.replace("-", "_").replace(".", "_")
        modname = f"{self.package}.{kind}.{stem}"
        spec = importlib.util.spec_from_file_location(modname, path)
        if spec is None:
            raise KeyError(f"no {kind} file {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def per_layer(self, workload: str) -> List[Dict[str, Any]]:
        """The per-layer metrics that ``workload`` reports: those that list
        it, and those without a list whose end-to-end metric it reports."""
        bench = self.bench()
        e2e = {m["name"]: m for m in bench["end_to_end"]}
        out = []
        for m in bench["per_layer"]:
            if "workloads" in m:
                if workload in m["workloads"]:
                    out.append(m)
            elif reports(e2e[m["moves"]], workload):
                out.append(m)
        return out

    def end_to_end(self, workload: str) -> List[Dict[str, Any]]:
        return [m for m in self.bench()["end_to_end"]
                if reports(m, workload)]


def reports(metric: Dict[str, Any], workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]
