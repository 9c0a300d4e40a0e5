"""What the benchmark loads: never JAX or the JAX package (by whole top-level module name), and the plain
reference nothing of the port."""

import ast
import json
import subprocess
import sys

from toy import BENCH, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "pyorc_tpu")


def _child(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": "", "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    """A whole toy run of each cell, traced, in a child process: every module it loaded, by top-level name."""
    found = _child(
        "import json, sys\n"
        f"sys.path[:0] = [{str(BENCH / 'tests')!r}]\n"
        "import toy, run, readings, control\n"
        "for name in toy.CELLS:\n"
        "    toy.run_toy(name, trace=True)\n"
        "for name in json.load(open('BENCHMARK.json'))['per_layer'] + json.load(open('BENCHMARK.json'))['end_to_end']:\n"
        "    run.reader(run.ROOT / 'benchmark' / 'metrics', name['name'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    assert "pyorc_tpu_torch" in found
    assert not set(found) & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    found = _child(
        "import json, sys\n"
        f"sys.path[:0] = [{str(BENCH)!r}]\n"
        "import reference.plain, reference.compare, traffic, roofline, work\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    assert not set(found) & set(FORBIDDEN + ("pyorc_tpu_torch",))


def test_the_reference_imports_name_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN + ("pyorc_tpu_torch",), (path.name, name)


def test_the_harness_reaches_the_chain_traffic_and_reference_only_through_a_route():
    for name in ("run.py", "control.py", "faults.py", "readings.py"):
        for node in ast.walk(ast.parse((BENCH / name).read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for imported in names:
                assert imported.split(".")[0] not in ("chain", "traffic", "reference"), (name, imported)
