"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration file, its traffic mix (``traffic/<name>.json``), the driver
of the mix's ``kind`` (``harness/<kind>.py``, a ``run(job)`` function) and
each per-layer metric's reader (``metrics/<name>.py``, a ``read(inputs,
window)`` function). Adding a cell, a configuration, a mix, a kind of cell
or a metric is adding files and entries; nothing here names one."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
KIND = re.compile(r"^[a-z][a-z0-9_]{0,63}$")


class Manifest:

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)
        self.bench_dir = os.path.join(root, self.data["paths"][0])

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        path = os.path.join(self.bench_dir, "traffic", name + ".json")
        with open(path) as f:
            return json.load(f)

    def driver(self, kind: str) -> Callable:
        """``run(job)`` of ``harness/<kind>.py``, imported by name."""
        if not KIND.match(kind):
            raise KeyError(f"no kind of cell {kind!r}")
        return importlib.import_module(f"portbench.harness.{kind}").run

    def _applies(self, metric: dict, workload: str) -> bool:
        if "workloads" in metric:
            return workload in metric["workloads"]
        return any(m["name"] == metric["moves"]
                   for m in self.end_to_end(workload))

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> List[dict]:
        return [m for m in self.data["per_layer"]
                if self._applies(m, workload)]

    def reader(self, metric: str) -> Callable:
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def readers(self, workload: str) -> Dict[str, Callable]:
        return {m["name"]: self.reader(m["name"])
                for m in self.per_layer(workload)}
