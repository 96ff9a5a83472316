"""What the harness finds by name: the cells, metrics and bounds of
``BENCHMARK.json``, and the files of each configuration, traffic mix,
limit set, per-layer metric and kernel group under ``portbench/``.

A later cell, mix, metric or kernel adds a file and an entry; no file
here needs an edit.
"""

import glob
import importlib.util
import json
import os
import re

__all__ = ["ROOT", "REPO", "Cell", "load_benchmark", "load_cell",
           "metric_reader", "kernel_groups", "peaks"]

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def load_benchmark(repo=REPO):
    return _json(os.path.join(repo, "BENCHMARK.json"))


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


class Cell:
    """One workload: its entry, configuration, traffic, limits and the
    metrics it reports."""

    def __init__(self, bench, name, root=ROOT, repo=REPO):
        self.entry = _named(bench["workloads"], name, "workload")
        self.name = name
        cfg = _named(bench["configs"], self.entry["config"], "config")
        self.config = _json(os.path.join(repo, cfg["file"]))
        self.traffic = _json(os.path.join(root, "traffic",
                                          self.entry["traffic"] + ".json"))
        self.limits = _json(os.path.join(root, "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in names)]
        self.root = root


def load_cell(name, repo=REPO, root=ROOT):
    return Cell(load_benchmark(repo), name, root, repo)


def metric_reader(name, root=ROOT):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = os.path.join(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kernel_groups(root=ROOT):
    """{group: [compiled name patterns]} from ``kernels/<group>/*.json``."""
    groups = {}
    for path in sorted(glob.glob(os.path.join(root, "kernels", "*", "*.json"))):
        group = os.path.basename(os.path.dirname(path))
        groups.setdefault(group, []).append(re.compile(_json(path)["pattern"]))
    return groups


def peaks(root=ROOT):
    return _json(os.path.join(root, "peaks.json"))
