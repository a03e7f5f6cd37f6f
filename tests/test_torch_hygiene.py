"""Package hygiene of the PyTorch port: it imports neither JAX nor mbrl_tpu,
its default device refuses to fall back to the CPU, and chip_smoke.py fails
without a CUDA device."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "mbrl_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_neither_jax_nor_mbrl_tpu():
    code = (
        "import sys, importlib\n"
        f"mods = {list(_modules())!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'mbrl_tpu' or k.startswith('mbrl_tpu.'))\n"
        "print(len(mods)); print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().splitlines()[-2:]
    assert int(n) >= 15
    assert bad == "[]", bad


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_statement_names_jax_or_mbrl_tpu(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "mbrl_tpu"), (path, name)


def _skip_on_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks behaviour without a CUDA device")


def test_default_device_raises_without_cuda():
    from mbrl_tpu_torch.models import GaussianMLP
    from mbrl_tpu_torch.planning import CEMOptimizer

    _skip_on_a_card()
    with pytest.raises(RuntimeError, match="cuda"):
        GaussianMLP(4, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        CEMOptimizer(1, 0.1, 10, [[0.0]], [[1.0]], alpha=0.1)
    GaussianMLP(4, 3, device="cpu")  # the explicit CPU path works


def test_chip_smoke_fails_without_cuda():
    _skip_on_a_card()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    lines = out.stdout.strip().splitlines()
    if lines:
        with pytest.raises(json.JSONDecodeError):
            json.loads(lines[-1])
