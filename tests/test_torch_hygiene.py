"""Package hygiene of the PyTorch port: it imports neither JAX nor mbrl_tpu,
its default device refuses to fall back to the CPU, and chip_smoke.py fails
without a CUDA device."""
import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
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
    assert int(n) >= 45
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
            assert root not in ("jax", "jaxlib", "flax", "optax", "mbrl_tpu"), (path, name)


def _chip_smoke_imports():
    """Every module of the port that chip_smoke.py imports, anywhere in the file."""
    mods = set()
    for node in ast.walk(ast.parse((REPO / "chip_smoke.py").read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("mbrl_tpu_torch"):
            mods.add(node.module)
            mods.update(f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Import):
            mods.update(a.name for a in node.names if a.name.startswith("mbrl_tpu_torch"))
    return sorted(mods)


def test_chip_smoke_imports_need_neither_gymnasium_nor_yaml():
    """The card's machine has neither ``gymnasium`` nor ``pyyaml``: with both
    (and JAX and the JAX package) made unimportable, everything chip_smoke.py
    imports still imports, a ``Config`` is built from its dict, and the model,
    the agent and the cartpole of config E are made from it, and config M's
    capped cartpole and a SAC learner, config PN's PlaNet model and pixel
    stand-in (with ``dm_control`` unimportable too), and config BE's
    BasicEnsemble."""
    mods = _chip_smoke_imports()
    assert "mbrl_tpu_torch.algorithms.pets" in mods or "mbrl_tpu_torch.algorithms" in mods
    code = (
        "import sys, importlib, importlib.abc\n"
        "BLOCKED = ('gymnasium', 'gym', 'yaml', 'jax', 'jaxlib', 'flax', 'optax', 'mbrl_tpu',\n"
        "           'dm_control')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ModuleNotFoundError(f'{name} is blocked in this test', name=name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import chip_smoke\n"
        f"mods = {mods!r}\n"
        "count = 0\n"
        "for m in mods:\n"
        "    try:\n"
        "        importlib.import_module(m); count += 1\n"
        "    except ModuleNotFoundError as e:\n"
        "        if e.name in BLOCKED or (e.name or '').split('.')[0] in BLOCKED: raise\n"
        "        # `from package import name` where name is a class or function\n"
        "        parent, _, attr = m.rpartition('.')\n"
        "        getattr(importlib.import_module(parent), attr)\n"
        "import copy\n"
        "from mbrl_tpu_torch.config import Config, complete_agent_cfg, create_one_dim_tr_model, instantiate\n"
        "from mbrl_tpu_torch.envs.cartpole_continuous import CartPoleEnv\n"
        "cfg = Config(copy.deepcopy(chip_smoke.CONFIG_E))\n"
        "env = CartPoleEnv()\n"
        "model = create_one_dim_tr_model(cfg, env.observation_space.shape, env.action_space.shape, device='cpu')\n"
        "agent = instantiate(complete_agent_cfg(env, cfg.algorithm.agent, device='cpu'), seed=1)\n"
        "obs, _ = env.reset(seed=0); env.step(env.action_space.sample())\n"
        "from mbrl_tpu_torch.util.env import make_env\n"
        "from mbrl_tpu_torch.planning import SAC\n"
        "import torch\n"
        "env_m, term_m, _ = make_env(Config(copy.deepcopy(chip_smoke.CONFIG_M)))\n"
        "sac = SAC(4, env_m.action_space, hidden_size=8, device='cpu')\n"
        "sac.init(torch.Generator().manual_seed(0))\n"
        "env_m.reset(seed=0); env_m.step(env_m.action_space.sample())\n"
        "cfg_pn = Config(copy.deepcopy(chip_smoke.CONFIG_PN))\n"
        "env_pn = chip_smoke.PixelCheetah()\n"
        "cfg_pn.dynamics_model['action_size'] = env_pn.action_space.shape[0]\n"
        "planet = instantiate(cfg_pn.dynamics_model, device='cpu')\n"
        "planet.update_posterior(planet.init(torch.Generator().manual_seed(0)), env_pn.reset()[0])\n"
        "env_pn.step(env_pn.action_space.sample())\n"
        "be = create_one_dim_tr_model(Config(copy.deepcopy(chip_smoke.CONFIG_BE)), (4,), (1,), device='cpu')\n"
        "assert type(be.model).__name__ == 'BasicEnsemble' and len(be) == 5\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in BLOCKED)\n"
        "print(count, len(model), type(agent).__name__); print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    summary, bad = out.stdout.strip().splitlines()[-2:]
    count, members, agent = summary.split()
    assert int(count) >= 12 and members == "7" and agent == "TrajectoryOptimizerAgent"
    assert bad == "[]", bad


@pytest.mark.parametrize("module,cls", [("pets_halfcheetah", "HalfCheetahEnv"),
                                        ("pets_cartpole", "CartPoleEnv")])
def test_preprocess_fn_imports_without_gymnasium(module, cls):
    """The YAML tree's ``obs_process_fn`` paths (and HalfCheetah's reward)
    import and run with ``gymnasium`` and ``mujoco`` unimportable; only making
    an environment reaches them."""
    code = (
        "import sys, importlib, importlib.abc\n"
        "BLOCKED = ('gymnasium', 'gym', 'mujoco', 'yaml', 'jax', 'mbrl_tpu', 'dm_control')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ModuleNotFoundError(f'{name} is blocked in this test', name=name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np, torch\n"
        "from mbrl_tpu_torch.config.engine import _import_target\n"
        f"fn = _import_target('mbrl_tpu_torch.envs.{module}.{cls}.preprocess_fn')\n"
        "out = fn(torch.zeros((3, 18)))\n"
        "import mbrl_tpu_torch.envs as envs\n"
        f"c = getattr(importlib.import_module('mbrl_tpu_torch.envs.{module}'), '{cls}')\n"
        "assert getattr(envs, 'PetsHalfCheetahEnv').__name__ == 'HalfCheetahEnv'\n"
        "try:\n"
        "    c()\n"
        "    made = 'made'\n"
        "except ModuleNotFoundError as e:\n"
        "    made = e.name.split('.')[0]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in BLOCKED)\n"
        "print(tuple(out.shape), made); print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    shapes, bad = out.stdout.strip().splitlines()[-2:]
    assert shapes.split(")")[0] + ")" in ("(3, 18)", "(3, 19)")
    assert shapes.endswith("gymnasium")  # making one needs gymnasium
    assert bad == "[]", bad


def test_yaml_is_imported_only_where_yaml_text_is_parsed():
    """``import yaml`` sits inside functions of config/engine.py, never at the
    top of a module of the port."""
    for path in PORT_FILES:
        for node in ast.parse(path.read_text()).body:
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for name in names:
                assert name.split(".")[0] not in ("yaml", "gymnasium", "optax"), (path, name)


def test_dm_control_is_imported_only_when_an_environment_is_made():
    """``util/dmcontrol_wrapper.py`` and ``util/env.py`` import ``dm_control``
    inside functions only: importing the port (and chip_smoke.py) loads none
    of it."""
    for path in PORT_FILES:
        for node in ast.parse(path.read_text()).body:
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            assert not any(n.split(".")[0] == "dm_control" for n in names), path
    code = (
        "import sys\n"
        "import mbrl_tpu_torch.util.dmcontrol_wrapper, mbrl_tpu_torch.util.env\n"
        "import mbrl_tpu_torch.algorithms.planet, chip_smoke\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('dm_control', 'mujoco')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_planet_model_and_conv_nets_default_to_the_card():
    from mbrl_tpu_torch.models import Conv2dDecoder, Conv2dEncoder, PlaNetModel

    _skip_on_a_card()
    with pytest.raises(RuntimeError, match="cuda"):
        Conv2dEncoder([(3, 8, 4, 2)], (16, 16), 8)
    with pytest.raises(RuntimeError, match="cuda"):
        Conv2dDecoder(8, (8, 1, 1), [(8, 3, 4, 2)])
    with pytest.raises(RuntimeError, match="cuda"):
        PlaNetModel((3, 16, 16), 8, [(3, 8, 4, 2)], [(8, 1, 1), [(8, 3, 4, 2)]], 2, 1, 4, 8)


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


def test_mbpo_entry_points_default_to_the_card(tmp_path):
    """SAC, SACAgent (through its SAC), DeviceReplayBuffer and mbpo.train
    default to device "cuda", which raises without a card; device="cpu"
    runs them. (util.env.make_env builds host environments: no device.)"""
    from mbrl_tpu_torch.algorithms import mbpo
    from mbrl_tpu_torch.config import load_config
    from mbrl_tpu_torch.envs.spaces import Box
    from mbrl_tpu_torch.planning import SAC, SACAgent
    from mbrl_tpu_torch.util.device_buffer import DeviceReplayBuffer
    from mbrl_tpu_torch.util.env import make_env

    _skip_on_a_card()
    space = Box(-1.0, 1.0, shape=(1,))
    with pytest.raises(RuntimeError, match="cuda"):
        SAC(4, space)
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceReplayBuffer(10, 4, 1)
    cfg = load_config(PORT / "examples" / "conf", "main",
                      overrides=["algorithm=mbpo", "overrides=mbpo_cartpole"])
    env, term_fn, _ = make_env(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        mbpo.train(env, env, term_fn, cfg, silent=True, work_dir=str(tmp_path))
    sac = SAC(4, space, hidden_size=8, device="cpu")
    SACAgent(sac, sac.init(torch.Generator().manual_seed(0))).act(np.zeros(4, np.float32))
    DeviceReplayBuffer(10, 4, 1, device="cpu").init()


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
