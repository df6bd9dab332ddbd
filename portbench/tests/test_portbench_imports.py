"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: ``repro_torch`` begins with ``repro``), and the
reference imports nothing of the program."""
import ast
import subprocess
import sys

from portbench import bench

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in bench.HERE.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_program():
    for name in ("reference", "check", "flops", "stream", "traffic",
                 "weights", "trace", "layout"):
        got = set(_imports(bench.HERE / f"{name}.py"))
        assert "repro_torch" not in got, name


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.path[:0] = ['.', 'src']\n"
        "from portbench.tests.tiny import run, tiny_cell\n"
        "out = run(tiny_cell('t5-paper-4x4.dynamic'), trace=True)\n"
        "run(tiny_cell('gpt-paper-8l.packing'))\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'repro'})\n"
        "assert out['correct'] and not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
