"""Command-line entry point (counterpart of ``mbrl_tpu/examples/main.py``)::

    python -m mbrl_tpu_torch.examples.main algorithm=pets overrides=pets_halfcheetah [k=v ...] [device=cpu]

Composes the port's YAML tree, makes the environment and its termination and
reward functions through ``util.env.create_handler``, writes the run directory
(``<root_dir>/<algorithm>/<experiment>/<env>/<date>/<time>``) with the composed
config as ``config.yaml`` (in a ``rank<r>`` directory below it when several
processes run), and runs ``pets``, ``mbpo`` (with a second
environment to test on) or ``planet``. ``device=`` (default ``cuda``) picks the
device of the run; it is taken off the arguments before the tree is composed,
so ``config.yaml`` is the JAX package's tree with the port's targets.

Before anything touches a device the process joins a process group when the
``MBRL_TPU_COORDINATOR``, ``MBRL_TPU_NUM_PROCESSES`` and
``MBRL_TPU_PROCESS_ID`` variables are set
(``parallel.maybe_initialize_distributed``), as the JAX CLI does; without
them a run is one process. Start one such process per device, with
``parallel=mesh`` to split the work over them.
"""
from __future__ import annotations

import datetime
import pathlib
import sys
from typing import List, Sequence, Tuple

from mbrl_tpu_torch.config import load_config, to_dict
from mbrl_tpu_torch.device import DeviceLike
from mbrl_tpu_torch.parallel.mesh import process_info
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


def _seed(env, seed) -> None:
    """The environment's reset noise and its action space's draws from ``seed``."""
    env.reset(seed=seed)
    env.action_space.seed(seed)


def run(cfg, device: DeviceLike = "cuda") -> float:
    import yaml

    handler = create_handler(cfg)
    env, term_fn, reward_fn = handler.make_env(cfg)
    # every process of a group seeds its environment alike, so that their
    # replay buffers, which a mesh needs equal, hold the same rows
    _seed(env, cfg.seed)

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
    rank, world = process_info()
    if world > 1:  # one run directory each: a directory takes one trainer
        work_dir = work_dir / f"rank{rank}"
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
        _seed(test_env, cfg.seed)
        return float(mbpo.train(env, test_env, term_fn, cfg, work_dir=str(work_dir),
                                device=device))
    if cfg.algorithm.name == "planet":
        from mbrl_tpu_torch.algorithms import planet

        return float(planet.train(env, cfg, work_dir=str(work_dir), device=device))
    raise ValueError(f"Unknown algorithm {cfg.algorithm.name!r}")


def main(argv: Sequence[str] = None) -> None:
    from mbrl_tpu_torch.parallel.multihost import maybe_initialize_distributed

    device, overrides = split_device(sys.argv[1:] if argv is None else argv)
    # joins the process group iff the MBRL_TPU_* variables are set; before any
    # device use
    joined = maybe_initialize_distributed(device)
    try:
        cfg = load_config(_CONF_DIR, "main", overrides=overrides)
        run(cfg, device=device)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
