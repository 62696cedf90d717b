"""What the benchmark loads: no module of ``portbench`` imports ``jax``,
``jaxlib``, ``flax`` or ``repro``, the reference imports nothing of the
program (``repro_torch``) either, and a run's process holds none of them
after its window. Top-level names are compared whole: ``repro_torch``
is not ``repro``."""
import ast
import json
import os
import subprocess
import sys

from portbench import harness

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path):
    tree = ast.parse(open(path).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(PB, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        tops = imported_tops(path)
        assert not tops & (FORBIDDEN | {"repro_torch", "portbench"}), path
        # relative imports stay inside the reference
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1, path


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys.modules[__name__])
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys.modules[__name__])
    assert "repro" in harness.forbidden_modules()


def test_a_run_loads_no_forbidden_module(tmp_path):
    from portbench.tests import tiny
    root = tiny.make_root(tmp_path, "dense")
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "res, rc = harness.run_cell(%r, 'tiny.t', 3, 0.1, False, "
        "device='cpu')\n"
        "tops = sorted({m.split('.', 1)[0] for m in sys.modules})\n"
        "print(json.dumps({'rc': rc, 'tops': tops}))\n"
        % (ROOT, os.path.join(ROOT, "src"), root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env={**os.environ,
                                                      "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0
    assert "repro_torch" in got["tops"]
    assert not set(got["tops"]) & FORBIDDEN


def test_a_module_loaded_by_the_check_withholds_the_result(tmp_path,
                                                          monkeypatch):
    """The guard runs after the reference and the judgement, so a
    forbidden module that the check itself loads still stops the run."""
    from portbench import check
    from portbench.tests import tiny
    root = tiny.make_root(tmp_path, "dense")
    judge = check.judge

    def judge_loading_jax(readings, limits):
        monkeypatch.setitem(sys.modules, "jax", sys.modules[__name__])
        return judge(readings, limits)
    monkeypatch.setattr(check, "judge", judge_loading_jax)
    assert harness.run_cell(root, "tiny.t", 3, 0.1, False,
                            device="cpu") == (None, 3)


def test_run_refuses_a_checkout_without_the_program(tmp_path):
    import shutil
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, str(tmp_path / "portbench" / "run.py"),
         "--workload", "minicpm-2b.solo", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
