"""Configurations, traffic mixes and per-layer metrics are found by name in
files of their own: a new one is a new file, found without an edit."""

import json
import pathlib
import re
import shutil

from portbench import spec


def test_new_files_are_found_by_name(tmp_path):
    for kind in ("configs", "traffic", "metrics"):
        shutil.copytree(f"{spec.HERE}/{kind}", tmp_path / kind)
    cfg = spec.load("configs", "ca-5k")
    (tmp_path / "configs" / "ca-7k.json").write_text(
        json.dumps({**cfg, "name": "ca-7k", "nodes": 7000}))
    (tmp_path / "traffic" / "burst-only.json").write_text(
        json.dumps({"variants": 2, "pending": True, "churn": 0, "burst": None,
                    "residents_leave_per_variant": 0}))
    (tmp_path / "metrics" / "pods_per_decision.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    assert spec.load("configs", "ca-7k", tmp_path)["nodes"] == 7000
    assert spec.load("traffic", "burst-only", tmp_path)["variants"] == 2
    assert spec.reader("pods_per_decision", tmp_path)(None) == 42.0
    assert spec.reader("phase_ms.filter", tmp_path).__module__.startswith(
        "portbench_metric_")


def test_every_listed_name_has_its_file():
    bench = spec.benchmark()
    for c in bench["configs"]:
        assert spec.load("configs", c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        spec.load("traffic", w["traffic"])
        assert spec.metrics_for(bench, "per_layer", w["name"])
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_each_roofline_names_kernels_of_the_port():
    """A roofline reader's KERNELS is a tuple of kernel names that the port's
    CUDA sources define (a bare string would match nothing)."""
    import importlib.util

    csrc = pathlib.Path(spec.ROOT, "kubernetes_autoscaler_tpu_torch", "csrc")
    source = "\n".join(p.read_text() for p in csrc.glob("*.cu"))
    for m in spec.benchmark()["per_layer"]:
        if not m["name"].endswith("_roofline"):
            continue
        path = pathlib.Path(spec.HERE, "metrics", f"{m['name']}.py")
        mod_spec = importlib.util.spec_from_file_location("roofline_reader", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        assert isinstance(mod.KERNELS, tuple) and mod.KERNELS, m["name"]
        for name in mod.KERNELS:
            assert re.search(rf"__global__[^;{{]*\b{name}\s*[<(]", source), name


def test_a_split_metric_reads_as_its_base():
    """`<name>.<cells>` readers that stand for `<name>` in other cells read
    the same number from the same run."""
    import types

    class Traced:
        decisions, variants = 2, [0, 1]

        def launches(self):
            return 330

        def kernel_ms(self, names):
            return 0.5

    ctx = types.SimpleNamespace(
        traced=Traced(), notes=[],
        roofline=lambda key, kernels: {"row_d": 28.0, "row_p": 4.0}[key])
    names = {m["name"] for m in spec.benchmark()["per_layer"]}
    split = [n for n in names if "." in n and n.rsplit(".", 1)[0] in names]
    assert split
    for n in split:
        assert spec.reader(n)(ctx) == spec.reader(n.rsplit(".", 1)[0])(ctx), n
