"""Nothing the benchmark runs loads JAX or the JAX package, whole top-level
names compared; and a run without a card, or without the program, prints
no result and exits non-zero."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from pio_bench import harness

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "predictionio_tpu"}


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "pio_bench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "predictionio_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "predictionio_tpu.ops.probe", sys)
    assert "predictionio_tpu" in harness.forbidden_modules()


_RUN = """
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import make_root
from pathlib import Path
from pio_bench import harness
root = make_root(Path({tmp!r}))
for w in ("small.ur", "small.cco"):
    for traced in (False, True):
        result, _ = harness.run(root, w, 11, 0.05, traced, device="cpu")
        assert result["correct"], result
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                   "port": "predictionio_tpu_torch" in sys.modules}}))
"""


def test_a_run_loads_the_port_and_nothing_of_jax(tmp_path):
    code = _RUN.format(root=str(ROOT), tests=str(ROOT / "pio_bench/tests"),
                       tmp=str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "port": True}


def run_py(cwd, *, pretend_card: bool):
    """run.py's main in a fresh process; with ``pretend_card`` torch
    reports one card, so the run goes on until it needs the program."""
    code = ("import runpy, sys, torch\n"
            + ("torch.cuda.is_available = lambda: True\n"
               "torch.cuda.device_count = lambda: 1\n" if pretend_card else "")
            + "sys.argv = ['pio_bench/run.py', '--workload', 'ur_train.catalog100k',"
              " '--seed', '1', '--seconds', '1', '--trace', '0']\n"
              "runpy.run_path('pio_bench/run.py', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=cwd)


def test_without_a_card_the_run_prints_no_result():
    out = run_py(ROOT, pretend_card=False)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_the_run_prints_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and pio_bench/."""
    import shutil

    shutil.copytree(ROOT / "pio_bench", tmp_path / "pio_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = run_py(tmp_path, pretend_card=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "predictionio_tpu_torch" in out.stderr
