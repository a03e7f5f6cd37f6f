"""Multi-process start-up on ``torch.distributed`` (counterpart of
``mbrl_tpu/parallel/multihost.py``).

One process per device. Initialisation is gated by the same three variables
as the JAX package's, so one launcher drives both packages and the same
entry point (``examples/main.py``) runs unchanged as one process:

  MBRL_TPU_COORDINATOR    host:port of rank 0 (its presence enables the group)
  MBRL_TPU_NUM_PROCESSES  the number of processes
  MBRL_TPU_PROCESS_ID     this process's rank in [0, num_processes)

The backend is ``nccl`` when the ranks compute on CUDA and every rank has a
card of its own, and ``gloo`` otherwise (NCCL refuses two ranks on one card).
:func:`maybe_initialize_distributed` prints the choice.

:func:`run_multihost_dryrun` starts N local processes that join one group
through those variables and each run this module's ``--child`` body: an
all-reduce across every rank (:func:`psum_check`), one sharded ensemble
training step (loss and gradients) and one sharded evaluation of planning
particles; the parent checks each child's report and returns their results.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import tempfile
from datetime import timedelta
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from mbrl_tpu_torch.device import DeviceLike, full_float32, resolve_device
from mbrl_tpu_torch.parallel.mesh import AXES, Mesh, make_mesh, process_info

_COORD = "MBRL_TPU_COORDINATOR"
_NPROC = "MBRL_TPU_NUM_PROCESSES"
_PID = "MBRL_TPU_PROCESS_ID"

__all__ = ["process_info", "local_worker_slice", "maybe_initialize_distributed",
           "choose_backend", "global_mesh", "psum_check", "run_multihost_dryrun"]


def choose_backend(num_processes: int, device: DeviceLike = "cuda") -> str:
    """``nccl`` when the ranks compute on CUDA and this host has a card for
    each of them, else ``gloo``."""
    on_cuda = torch.device(device).type == "cuda" and torch.cuda.is_available()
    return "nccl" if on_cuda and torch.cuda.device_count() >= num_processes else "gloo"


def maybe_initialize_distributed(device: DeviceLike = "cuda", timeout_s: float = 600.0) -> bool:
    """Join the process group iff the coordinator variables are set (False,
    and nothing done, otherwise). Call once, before anything touches a
    device. Under ``nccl`` each rank takes the card of its rank."""
    coord = os.environ.get(_COORD)
    if not coord:
        return False
    num_processes = int(os.environ[_NPROC])
    rank = int(os.environ[_PID])
    backend = choose_backend(num_processes, device)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        why = "a card for each rank"
    elif torch.device(device).type == "cuda":
        why = f"{num_processes} ranks share {torch.cuda.device_count()} card(s)"
    else:
        why = "ranks on the CPU"
    print(f"process group: rank {rank} of {num_processes}, backend {backend} ({why})",
          flush=True)
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=num_processes,
                            rank=rank, timeout=timedelta(seconds=timeout_s))
    return True


def global_mesh(model_axis_size: Optional[int] = None) -> Mesh:
    """The (model, data) mesh over every process of the group."""
    return make_mesh(model_axis_size=model_axis_size)


def local_worker_slice(num_workers_total: int) -> range:
    """This process's contiguous share of the real-environment worker pool:
    the first ``num_workers_total % num_processes`` processes get one more."""
    pid, nproc = process_info()
    per = num_workers_total // nproc
    extra = num_workers_total % nproc
    start = pid * per + min(pid, extra)
    stop = start + per + (1 if pid < extra else 0)
    return range(start, stop)


def _collective_device() -> torch.device:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def psum_check(mesh: Optional[Mesh] = None, device: Optional[DeviceLike] = None) -> float:
    """All-reduce of one per rank over the whole mesh: the number of ranks when
    the group and the mesh are wired right."""
    mesh = global_mesh() if mesh is None else mesh
    one = torch.ones((1,), device=_collective_device() if device is None else device)
    return float(mesh.all_reduce(one, AXES).item())


# --------------------------------------------------------------------------- #
# The dry run
# --------------------------------------------------------------------------- #
def default_case(world_size: int) -> Dict[str, Any]:
    """A small seeded case for the dry run's training step and plan: two
    members for each rank of a model axis of 2 (1 when the world is odd),
    four rows for each rank of the data axis."""
    model_axis = 2 if world_size % 2 == 0 else 1
    ensemble, rows = 2 * model_axis, 4 * (world_size // model_axis)
    obs_dim, act_dim = 4, 2
    rng = np.random.default_rng(0)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return {
        "model": dict(in_size=obs_dim + act_dim, out_size=obs_dim + 1, num_layers=2,
                      ensemble_size=ensemble, hid_size=16, activation="silu",
                      propagation_method="random_model"),
        "wrapper": dict(target_is_delta=True, normalize=False, learned_rewards=True),
        "state": None,  # the model's init from seed 0
        "batch": (f(ensemble, rows, obs_dim), f(ensemble, rows, act_dim),
                  f(ensemble, rows, obs_dim), f(ensemble, rows, 1),
                  np.zeros((ensemble, rows, 1), bool), np.zeros((ensemble, rows, 1), bool)),
        "model_axis_size": model_axis,
        "plan": {"sequences": rng.uniform(-1, 1, (4 * world_size, 3, act_dim)).astype(np.float32),
                 "initial_obs": np.zeros((obs_dim,), np.float32), "num_particles": 2,
                 "seed": 2, "fast_rollout": False},
    }


def _build(case: Dict[str, Any], device: torch.device):
    from mbrl_tpu_torch.convert import convert_state
    from mbrl_tpu_torch.models import GaussianMLP, TransitionRewardModel

    model = GaussianMLP(device=device, **case["model"])
    wrapper = TransitionRewardModel(model, **case["wrapper"])
    if case.get("state") is None:
        state = wrapper.init(torch.Generator().manual_seed(0))
    else:
        state = convert_state(case["state"], device)
    return wrapper, state


def sharded_step(case: Dict[str, Any], mesh: Mesh, device: DeviceLike) -> Dict[str, Any]:
    """One training step of ``case`` on this rank's block of the mesh (its
    loss and every trainable leaf's gradient, whole, in full float32); for a
    ``train`` and a ``train_clipped`` in the case, a :func:`train_on_batch`
    call (losses, scores, the trained params); for a ``plan`` and a
    ``plan_generic``, a :func:`sharded_plan` (values, launches): numpy
    results."""
    from mbrl_tpu_torch.models import ModelTrainer
    from mbrl_tpu_torch.ops.tree import tree_leaves_with_path
    from mbrl_tpu_torch.parallel.context import ParallelContext
    from mbrl_tpu_torch.types import TransitionBatch

    device = torch.device(device)
    wrapper, state = _build(case, device)
    pctx = ParallelContext(mesh)
    trainer = ModelTrainer(wrapper, parallel_ctx=pctx)
    with full_float32():
        loss, grads = trainer.loss_and_grads(state, TransitionBatch(*case["batch"]))
    out = {"loss": float(loss), "grads": {"/".join(map(str, k)): v.cpu().numpy()
                                          for k, v in grads.items()}}
    for key in ("train", "train_clipped"):
        train = case.get(key)
        if train is None:
            continue
        new, losses, vals = train_on_batch(trainer, state, case["batch"], train, device)
        out[f"{key}_losses"], out[f"{key}_vals"] = losses, vals
        out[f"{key}_params"] = {"/".join(map(str, k)): v.cpu().numpy()
                                for k, v in tree_leaves_with_path(new["params"])}
    for key in ("plan", "plan_generic"):
        if case.get(key) is not None:
            got = sharded_plan(wrapper, state, case[key], pctx)
            out.update({f"{key}_{name}": v for name, v in got.items()})
    return out


def sharded_plan(wrapper, state, plan: Dict[str, Any], pctx) -> Dict[str, Any]:
    """``plan["keys"]`` sharded evaluations (default 1) of ``plan``'s
    sequences, generator seeds ``seed``, ``seed + 1``, ...; the model's
    learned rewards unless the plan gives a ``reward_fn``. Returns the values
    (``(keys, population)``; ``(population,)`` for one key) and the kernel
    launches they made on this rank."""
    from mbrl_tpu_torch.envs.termination_fns import no_termination
    from mbrl_tpu_torch.models import ModelEnv
    from mbrl_tpu_torch.ops import kernels

    wrapper.model.supports_fast_rollout = bool(plan["fast_rollout"])
    env = ModelEnv(wrapper, plan.get("termination_fn", no_termination),
                   reward_fn=plan.get("reward_fn"),
                   particle_sharding=None if pctx is None else pctx.particle_sharding())
    before = kernels.launch_counts()
    values = [env.evaluate_action_sequences(
        state, plan["sequences"], plan["initial_obs"],
        torch.Generator().manual_seed(plan["seed"] + k), num_particles=plan["num_particles"]
    ).cpu().numpy() for k in range(plan.get("keys", 1))]
    launches = {k: n - before[k] for k, n in kernels.launch_counts().items()}
    return {"values": values[0] if "keys" not in plan else np.stack(values),
            "launches": launches}


def train_on_batch(trainer, state, batch, train: Dict[str, Any], device: torch.device):
    """A ``train_device`` call, in full float32, on the (E, B) rows of
    ``batch`` as one dataset: ``train`` gives its batch size, validation
    share, epochs, seed and, optionally, ``grad_clip_norm``."""
    from mbrl_tpu_torch.util.device_buffer import DeviceTransitionDataset
    from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

    rows = [np.asarray(x).reshape((-1,) + np.asarray(x).shape[2:]) for x in batch]
    buffer = ReplayBuffer(len(rows[0]), rows[0].shape[1:], rows[1].shape[1:])
    buffer.add_batch(rows[0], rows[1], rows[2], rows[3].reshape(-1), rows[4].reshape(-1),
                     rows[5].reshape(-1))
    dataset = DeviceTransitionDataset(rows[0].shape[1], rows[1].shape[1], device=device)
    dataset.sync_from(buffer)
    trainer.model.grad_clip_norm = train.get("grad_clip_norm")
    with full_float32():
        return trainer.train_device(
            state, dataset, batch_size=train["batch_size"], val_ratio=train["val_ratio"],
            num_epochs=train["epochs"], generator=torch.Generator().manual_seed(train["seed"]))


def _child(device: str, case_path: Optional[str], out_dir: str) -> None:
    device = resolve_device(device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    if not maybe_initialize_distributed(device):
        raise SystemExit("the MBRL_TPU_* variables are not set")
    rank, world = process_info()
    mesh_probe = global_mesh(model_axis_size=1)
    print(f"psum={int(psum_check(mesh_probe))}", flush=True)
    if case_path:
        with open(case_path, "rb") as f:
            case = pickle.load(f)  # written by run_multihost_dryrun from its caller's case
    else:
        case = default_case(world)
    mesh = global_mesh(model_axis_size=case["model_axis_size"])
    result = sharded_step(case, mesh, device)
    result.update(rank=rank, world=world, mesh=dict(mesh.shape))
    with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank}: loss {result['loss']:.6f}", flush=True)
    print("MULTIHOST OK", flush=True)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_multihost_dryrun(num_processes: int = 2, timeout_s: float = 300.0,
                         device: DeviceLike = "cuda",
                         case: Optional[Dict[str, Any]] = None) -> List[Dict[str, Any]]:
    """Start ``num_processes`` local processes that form one process group
    through the ``MBRL_TPU_*`` variables and run the ``--child`` body (module
    docstring) on ``device`` (raises without a card unless ``"cpu"``) with
    ``case`` (default: :func:`default_case`). Checks that every child printed
    ``psum=<num_processes>`` and ``MULTIHOST OK`` and that the losses agree;
    returns each rank's results (loss, gradients, plan values), in rank order."""
    device = resolve_device(device)
    root = pathlib.Path(__file__).resolve().parents[2]
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="mbrl_multihost_") as tmp:
        cmd = [sys.executable, "-u", "-m", "mbrl_tpu_torch.parallel.multihost", "--child",
               "--device", str(device), "--out", tmp]
        if case is not None:
            case_path = pathlib.Path(tmp) / "case.pkl"
            with open(case_path, "wb") as f:
                pickle.dump(case, f)
            cmd += ["--case", str(case_path)]
        env = dict(os.environ)
        env.update({_COORD: f"127.0.0.1:{port}", _NPROC: str(num_processes),
                    "PYTHONPATH": os.pathsep.join(
                        [str(root)] + [p for p in [env.get("PYTHONPATH")] if p])})
        procs = []
        try:
            for pid in range(num_processes):
                procs.append(subprocess.Popen(
                    cmd, env={**env, _PID: str(pid)}, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
            outputs = [p.communicate(timeout=timeout_s)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for pid, (p, out) in enumerate(zip(procs, outputs)):
            if p.returncode != 0:
                raise RuntimeError(f"multihost child {pid} failed (exit {p.returncode}):\n{out}")
            if f"psum={num_processes}" not in out or "MULTIHOST OK" not in out:
                raise RuntimeError(f"multihost child {pid} did not report psum and OK:\n{out}")
        results = []
        for pid in range(num_processes):
            with open(pathlib.Path(tmp) / f"rank{pid}.pkl", "rb") as f:
                results.append(pickle.load(f))
    losses = [r["loss"] for r in results]
    if len(set(losses)) != 1:
        raise RuntimeError(f"the ranks' losses differ: {losses}")
    print(f"run_multihost_dryrun OK: {num_processes} processes on {device}, "
          f"mesh {results[0]['mesh']}, psum and a sharded training step validated", flush=True)
    return results


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="the child body of run_multihost_dryrun")
    parser.add_argument("--child", action="store_true", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--case", default=None)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    _child(args.device, args.case, args.out)
