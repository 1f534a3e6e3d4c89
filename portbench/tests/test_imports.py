"""Nothing the harness runs loads JAX or the JAX package, and the plain
reference loads nothing of the program.  Module names are compared by
their top-level name whole: the program's package name begins with the
JAX package's."""
import ast
import glob
import os
import subprocess
import sys

from portbench.core.cell import FORBIDDEN, forbidden_modules
from portbench.core.spec import PORTBENCH, REPO

PROGRAM = "occdepth_tpu_torch"


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=PORTBENCH, timeout=300)


def test_top_level_names_compared_whole():
    sys.modules.setdefault("occdepth_tpu_torch_probe_x", object())
    try:
        assert "occdepth_tpu_torch_probe_x" not in forbidden_modules()
    finally:
        del sys.modules["occdepth_tpu_torch_probe_x"]
    assert "occdepth_tpu" in FORBIDDEN and PROGRAM not in FORBIDDEN


def test_reference_imports_no_program_and_no_jax():
    code = (
        "import sys\n"
        "import portbench.reference.model, portbench.reference.losses\n"
        "import portbench.reference.config, portbench.core.lowp\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        f"{set(FORBIDDEN) | {PROGRAM}!r})\n"
        "print(bad)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_harness_run_loads_no_jax():
    """A whole tiny run of the harness, in a fresh process with JAX and
    the JAX package unimportable: it completes, and nothing forbidden is
    loaded at its end."""
    code = (
        "import sys, tempfile, time\n"
        "for m in ('jax', 'jaxlib', 'flax', 'occdepth_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from portbench.tests.helpers import tiny_bench\n"
        "from portbench.core.cell import run_cell, forbidden_modules\n"
        "b = tiny_bench(tempfile.mkdtemp())\n"
        "r = run_cell('tiny_kitti.serve_tiny', 3, 0.5, False,"
        " time.perf_counter(), 'cpu', b)\n"
        "assert r['correct'], r['checks']\n"
        "print([m for m in forbidden_modules() if sys.modules[m] is not"
        " None])\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_neither_jax_nor_the_jax_package():
    """Every module of the benchmark's folder, tests aside: no import of
    JAX or the JAX package, the reference no import of the program, and
    no reads of the root bench.py or BENCH_* files."""
    files = [f for f in glob.glob(os.path.join(PORTBENCH, "**", "*.py"),
                                  recursive=True)
             if os.sep + "tests" + os.sep not in f]
    assert files
    for f in files:
        with open(f) as fh:
            src = fh.read()
        assert "BENCH_" not in src and "bench.py" not in src, f
        for node in ast.walk(ast.parse(src)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top not in FORBIDDEN, (f, n)
                if os.sep + "reference" + os.sep in f:
                    assert top != PROGRAM, (f, n)
