"""Command-line entry point (counterpart of ``mbrl_tpu/examples/main.py``)::

    python -m mbrl_tpu_torch.examples.main algorithm=pets overrides=pets_halfcheetah [k=v ...] [device=cpu]

Composes the port's YAML tree, makes the environment and its termination and
reward functions through ``util.env.create_handler``, writes the run directory
(``<root_dir>/<algorithm>/<experiment>/<env>/<date>/<time>``) with the composed
config as ``config.yaml``, and runs ``pets``, ``mbpo`` (with a second
environment to test on) or ``planet``. ``device=`` (default ``cuda``) picks the
device of the run; it is taken off the arguments before the tree is composed,
so ``config.yaml`` is the JAX package's tree with the port's targets.

The JAX package joins a multi-host process group here first
(``maybe_initialize_distributed``); that belongs to ``parallel/``, which the
port has not taken up yet, so a run here is one process.
"""
from __future__ import annotations

import datetime
import pathlib
import sys
from typing import List, Sequence, Tuple

from mbrl_tpu_torch.config import load_config, to_dict
from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.util.env import create_handler

_CONF_DIR = pathlib.Path(__file__).parent / "conf"


def split_device(args: Sequence[str]) -> Tuple[str, List[str]]:
    """The ``device=`` argument (default ``cuda``) and the other arguments."""
    device, rest = "cuda", []
    for arg in args:
        if arg.startswith("device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return device, rest


def run(cfg, device: DeviceLike = "cuda") -> float:
    import yaml

    handler = create_handler(cfg)
    env, term_fn, reward_fn = handler.make_env(cfg)

    # run dir and config snapshot (diagnostics reload from here)
    now = datetime.datetime.now()
    work_dir = (
        pathlib.Path(cfg.root_dir)
        / cfg.algorithm.name
        / str(cfg.experiment)
        / str(cfg.overrides.env).replace("___", "-")
        / now.strftime("%Y.%m.%d")
        / now.strftime("%H%M%S")
    )
    work_dir.mkdir(parents=True, exist_ok=True)
    with open(work_dir / "config.yaml", "w") as f:
        yaml.safe_dump(to_dict(cfg), f)

    if cfg.algorithm.name == "pets":
        from mbrl_tpu_torch.algorithms import pets

        return float(pets.train(env, term_fn, reward_fn, cfg, work_dir=str(work_dir),
                                device=device))
    if cfg.algorithm.name == "mbpo":
        from mbrl_tpu_torch.algorithms import mbpo

        test_env, *_ = create_handler(cfg).make_env(cfg)
        return float(mbpo.train(env, test_env, term_fn, cfg, work_dir=str(work_dir),
                                device=device))
    if cfg.algorithm.name == "planet":
        from mbrl_tpu_torch.algorithms import planet

        return float(planet.train(env, cfg, work_dir=str(work_dir), device=device))
    raise ValueError(f"Unknown algorithm {cfg.algorithm.name!r}")


def main(argv: Sequence[str] = None) -> None:
    device, overrides = split_device(sys.argv[1:] if argv is None else argv)
    cfg = load_config(_CONF_DIR, "main", overrides=overrides)
    run(cfg, device=device)


if __name__ == "__main__":
    main()
