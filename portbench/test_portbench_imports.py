"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: the port's name begins with the JAX package's), and a run without the
cards it asks for, or without the port, exits without a result."""
import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FOREIGN = {"jax", "jaxlib", "flax", "mbrl_tpu"}


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in FOREIGN, (path, name)


def test_every_module_a_run_loads():
    """A whole run at a toy size in a fresh process: the modules it holds once
    the window has closed and the comparison is done."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from portbench import harness, run\n"
        "for cell in ('mbpo_walker.rollout', 'mbpo_hum.rollout'):\n"
        f"    r = harness.run_cell({str(ROOT)!r}, cell, 5, 0.1, cell.startswith('mbpo_hum'),\n"
        "        device='cpu', scale={'start_states': 100, 'capacity': 5000, 'real_rows': 500})\n"
        "    assert r['correct'], r\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps(tops))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "mbrl_tpu_torch" in tops and "portbench" in tops
    assert not tops & FOREIGN, tops & FOREIGN


def _run(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "mbpo_walker.rollout",
                           "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd)


def test_without_a_card_a_run_exits_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_with_only_the_benchmark_a_run_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
