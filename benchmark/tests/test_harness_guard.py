"""The import check: nothing under benchmark/ names JAX, flax or the
JAX package, the reference names nothing of the program, and a loaded
module is judged by its whole top-level name."""
import subprocess
import sys

from benchmark.harness import guard
from conftest import ROOT


def test_sources_import_nothing_forbidden():
    assert guard.scan() == []


def test_names_compared_whole():
    assert guard.forbidden_modules(["jax.numpy", "flax", "dagr_tpu.ops",
                                    "jaxlib"]) == [
        "dagr_tpu.ops", "flax", "jax.numpy", "jaxlib"]
    assert guard.forbidden_modules(["dagr_tpu_torch.serve", "jaxtyping",
                                    "flaxen", "torch"]) == []


def test_scan_flags_a_planted_import(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "x.py").write_text(
        "import dagr_tpu_torch.serve\n")
    (tmp_path / "y.py").write_text("from jax import numpy\n")
    (tmp_path / "z.py").write_text("import dagr_tpu_torch\n")
    assert guard.scan(tmp_path) == ["reference/x.py: dagr_tpu_torch.serve",
                                    "y.py: jax"]


def test_reference_loads_none_of_the_program():
    code = ("import sys; import benchmark.reference.model, "
            "benchmark.reference.train, benchmark.reference.loss, "
            "benchmark.harness.arith, benchmark.harness.weights, "
            "benchmark.harness.traffic; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('dagr_tpu_torch', 'dagr_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_run_refuses_without_a_card_or_files(tmp_path):
    """Without a card, or in a directory without the program, the run
    exits non-zero and prints no result."""
    import shutil

    code = [sys.executable, "benchmark/run.py", "--workload",
            "dagr-s-dsec.sync-b1", "--seed", "1", "--seconds", "1",
            "--trace", "0"]
    out = subprocess.run(code, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                           "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "benchmark", bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    out = subprocess.run(code, cwd=bare, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
