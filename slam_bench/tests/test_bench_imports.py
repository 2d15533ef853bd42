"""What the benchmark loads: nothing it runs imports JAX or the JAX package,
and the reference imports nothing of the port. Each check compares the
top-level name of a module (the part before the first dot) whole, since the
port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)

JAX = {"jax", "jaxlib", "flax", "sonar_slam_tpu"}
PORT = "sonar_slam_torch"


def top_levels_loaded(code: str) -> set:
    """Top-level names in ``sys.modules`` after ``code`` runs in a fresh
    interpreter started in the repository's root."""
    probe = (code + "\nimport sys\n"
             "print(sorted({m.split('.')[0] for m in list(sys.modules)}))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def imported_names(path: str) -> set:
    """Top-level names of every absolute import in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub: str = ""):
    for d, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_top_level_names_compare_whole():
    assert PORT.split(".")[0] not in JAX
    assert PORT.startswith("sonar_slam_t")  # shares a prefix, not a name


def test_harness_sources_import_no_jax():
    for path in sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not (imported_names(path) & JAX), path


def test_reference_sources_import_nothing_of_the_port():
    for path in sources("reference"):
        assert not (imported_names(path) & (JAX | {PORT})), path
    assert not (imported_names(os.path.join(BENCH_DIR, "simulate.py"))
                & (JAX | {PORT}))


def test_reference_loads_nothing_of_the_port():
    loaded = top_levels_loaded(
        "import slam_bench.simulate, slam_bench.reference.stages, "
        "slam_bench.reference.precision")
    assert not (loaded & (JAX | {PORT}))


def test_a_run_loads_no_jax():
    loaded = top_levels_loaded(
        "import sys; sys.path.insert(0, 'slam_bench')\n"
        "import run\n"
        "from slam_bench.harness import check, common, configs, trace\n"
        "import sonar_slam_torch.pipeline, sonar_slam_torch.estimators\n"
        "configs.port_types(); configs.reference_types()\n"
        "import json, types\n"
        "bench = run.load_json('BENCHMARK.json')\n"
        "for w in bench['workloads']:\n"
        "    run.driver_module(run.Cell.find(bench, w['name']))\n"
        "    for m in bench['end_to_end'] + bench['per_layer']:\n"
        "        run.reader(m['name'])")
    assert PORT in loaded
    assert not (loaded & JAX)
