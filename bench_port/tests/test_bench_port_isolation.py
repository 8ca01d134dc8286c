"""The benchmark measures the port alone: nothing it loads has the
top-level name of JAX, flax or the JAX package (compared whole, since the
port's name begins with the JAX package's), the reference imports nothing
of the port, and a run without a card, or without the port, prints no
result and exits non-zero: a measurement never falls back to the CPU."""

import ast
import os
import shutil
import subprocess
import sys

from bench_port.harness.common import BANNED, ROOT

HERE = os.path.join(ROOT, "bench_port")
PORT = "imagecompressionlearnedliftingandlearnedtreebasedmodels_torch"


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield 0, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.level, node.module or ""


def test_loaded_modules_exclude_jax_and_the_jax_package():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from bench_port.tests.small import cells, rehearse\n"
        "for cell in cells():\n"
        "    assert rehearse(cell, seconds=0.2)[0]['correct']\n"
        "import bench_port.calibrate, bench_port.reference.model\n"
        "from bench_port.harness.common import banned_modules\n"
        "print(banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_banned_names_are_compared_whole():
    assert PORT.split(".")[0] not in BANNED
    assert PORT.startswith(BANNED[-1][:-4])


def test_reference_imports_nothing_of_the_port():
    """Every file of ``reference/``, its part folders too, imports only
    ``torch``, the standard library and ``reference/`` itself."""
    ref = os.path.join(HERE, "reference")
    files = [os.path.join(base, f) for base, _, names in os.walk(ref)
             for f in names if f.endswith(".py")]
    assert any(os.sep in os.path.relpath(f, ref) for f in files)
    for path in files:
        name = os.path.relpath(path, ref)
        depth = name.count(os.sep) + 1     # relative levels up to reference/
        for level, mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in BANNED and top != PORT, (name, mod)
            if level:
                assert level <= depth, (name, mod)  # nothing outside it
            else:
                assert top in sys.stdlib_module_names or top == "torch" \
                    or mod.startswith("bench_port.reference"), (name, mod)


def test_only_one_module_imports_the_port():
    found = []
    for base, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py") and not f.startswith("test_"):
                path = os.path.join(base, f)
                with open(path) as fh:
                    if PORT in fh.read():
                        found.append(os.path.relpath(path, HERE))
    assert found == [os.path.join("harness", "port.py")]


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "bench_port", "run.py"),
         "--workload", "cdf97_fp32.eval", "--seed", str(2 ** 31 + 3),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_run_without_a_card_prints_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_without_the_port_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
