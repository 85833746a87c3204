"""Where the harness finds a cell's parts: by name, in files of their own.

`BENCHMARK.json` (at the checkout's root) names each cell's configuration
and traffic; the configuration is `configs/<config>.json`, the traffic
`traffic/<traffic>.json`, and each per-layer metric `<name>` is read by
`metrics/<name>.py`, a module with `read(ctx) -> float | None`. A later
cell, configuration or metric is a new entry and a new file; no file here
changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load(kind: str, name: str, base: str = HERE) -> dict:
    """configs/<name>.json or traffic/<name>.json under `base`."""
    with open(os.path.join(base, kind, f"{name}.json")) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")


def metrics_for(bench: dict, section: str, workload: str) -> list[dict]:
    """The `end_to_end` or `per_layer` metrics that this cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, base: str = HERE):
    """The `read` function of metrics/<name>.py under `base`."""
    path = os.path.join(base, "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
