"""Nothing the harness or the reference loads is JAX or the JAX package, and
the reference loads nothing of the program either. Top-level module names
are compared whole: the port's name begins with the JAX package's."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
JAX_SIDE = {"jax", "jaxlib", "flax", "kubernetes_autoscaler_tpu"}
PORT = "kubernetes_autoscaler_tpu_torch"


def static_imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_of_the_benchmark_names_jax():
    for path in BENCH.rglob("*.py"):
        assert not static_imports(path) & JAX_SIDE, path


def test_no_file_of_the_reference_names_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert PORT not in static_imports(path), path


def loaded_by(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c",
         code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(out.stdout.split())


def test_the_reference_loads_nothing_of_the_program_or_jax():
    mods = loaded_by(
        "import portbench.reference.decide, portbench.control, "
        "portbench.judge, portbench.bounds, portbench.world")
    assert not mods & (JAX_SIDE | {PORT}), mods & (JAX_SIDE | {PORT})


@pytest.mark.parametrize("cell", ["ca-5k.steady", "ca-5k-affinity.consolidate"])
def test_a_whole_run_loads_no_jax(cell):
    mods = loaded_by(
        "from portbench.tests.conftest import small_run\n"
        f"assert small_run({cell!r})['correct']")
    assert PORT in mods
    assert not mods & JAX_SIDE, mods & JAX_SIDE
