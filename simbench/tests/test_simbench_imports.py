"""Nothing under simbench/ imports JAX or the JAX package, the reference
imports nothing of the program, and a run without a card prints no
result."""
import ast
import pathlib
import shutil
import subprocess
import sys

from simbench.harness import cell as cm

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f
        text = f.read_text()
        assert "importlib.import_module(\"repro.\"" not in text


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in set(_imports(f)), f
        assert "repro_torch" not in f.read_text(), f


def test_the_run_finds_a_loaded_jax_package():
    assert cm.forbidden_loaded(["repro_torch.api", "torch", "numpy"]) == []
    assert cm.forbidden_loaded(["repro_torch", "repro.core"]) == ["repro"]
    assert cm.forbidden_loaded(["jax.numpy", "flax"]) == ["flax", "jax"]


def _run(cwd):
    return subprocess.run(
        [sys.executable, "simbench/run.py", "--workload",
         "resnet18.trace64k", "--seed", "1", "--seconds", "1"],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_a_run_without_a_card_prints_no_result():
    p = _run(BENCH.parent)
    assert p.returncode != 0 and p.stdout == ""


def test_a_run_without_the_program_prints_no_result(tmp_path):
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
