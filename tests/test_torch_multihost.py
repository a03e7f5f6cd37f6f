"""Multi-process start-up of the port (``mbrl_tpu_torch/parallel/multihost.py``)
on the CPU: the ``MBRL_TPU_*`` variables, the backend rule, the two-process
dry run (``psum=2``, one sharded training step whose loss and gradients equal
the one-process step's) and the CLI joining a group of two."""
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mbrl_tpu_torch.models import ModelTrainer
from mbrl_tpu_torch.parallel import maybe_initialize_distributed, multihost
from mbrl_tpu_torch.types import TransitionBatch

REPO = pathlib.Path(__file__).resolve().parent.parent
_VARS = ("MBRL_TPU_COORDINATOR", "MBRL_TPU_NUM_PROCESSES", "MBRL_TPU_PROCESS_ID")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the test workers share the
    CPU, and a pool of threads per worker over small products slows them all
    many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_no_group_without_the_variables(monkeypatch):
    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    assert maybe_initialize_distributed("cpu") is False
    assert not dist.is_initialized()
    assert multihost.process_info() == (0, 1)
    assert multihost.psum_check() == 1.0  # one rank, no collective


@pytest.mark.parametrize("device,cards,processes,backend", [
    ("cpu", 0, 2, "gloo"), ("cpu", 4, 2, "gloo"), ("cuda", 1, 2, "gloo"),
    ("cuda", 2, 2, "nccl"), ("cuda", 4, 2, "nccl"), ("cuda", 4, 8, "gloo"),
])
def test_backend_is_nccl_only_with_a_card_for_each_rank(device, cards, processes, backend,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert multihost.choose_backend(processes, device) == backend


def test_two_process_dryrun_matches_one_process():
    """Two processes join through the variables, print psum=2 and MULTIHOST
    OK (checked by run_multihost_dryrun), and split the default case's eight
    members over a model axis of 2: both ranks report the one-process loss and
    every gradient."""
    results = multihost.run_multihost_dryrun(2, timeout_s=240, device="cpu")
    assert [r["rank"] for r in results] == [0, 1] and results[0]["mesh"] == {"model": 2, "data": 1}
    case = multihost.default_case(2)
    wrapper, state = multihost._build(case, torch.device("cpu"))
    loss, grads = ModelTrainer(wrapper).loss_and_grads(state, TransitionBatch(*case["batch"]))
    for r in results:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-6)
        assert r["grads"].keys() == {"/".join(map(str, k)) for k in grads}
        for k, g in grads.items():
            np.testing.assert_allclose(r["grads"]["/".join(map(str, k))], g.numpy(),
                                       rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(results[0]["plan_values"], results[1]["plan_values"])


def _cli_ranks(tmp_path, *extra: str):
    """Two ranks of the CLI, joined through the variables, ``parallel=mesh``
    with the data axis two wide, a small PETS budget on the CPU: the
    processes and their outputs."""
    port = multihost._free_port()
    args = [sys.executable, "-m", "mbrl_tpu_torch.examples.main", "algorithm=pets",
            "overrides=pets_cartpole", "parallel=mesh", "parallel.model_axis_size=1",
            "device=cpu", f"root_dir={tmp_path}", "overrides.num_steps=30",
            "overrides.trial_length=15", "algorithm.initial_exploration_steps=20",
            "overrides.freq_train_model=15", "overrides.cem_population_size=20",
            "overrides.cem_num_iters=2", "overrides.planning_horizon=4",
            "algorithm.num_particles=4", "overrides.num_epochs_train_model=2",
            "dynamics_model.hid_size=16", "dynamics_model.num_layers=2", *extra]
    env = {**os.environ, "MBRL_TPU_COORDINATOR": f"127.0.0.1:{port}",
           "MBRL_TPU_NUM_PROCESSES": "2", "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(args, cwd=tmp_path, env={**env, "MBRL_TPU_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return procs, outs


def test_cli_refuses_a_pool_under_a_mesh_of_two(tmp_path):
    """A worker pool with ``parallel=mesh`` over two processes: both ranks
    join, then refuse before a worker starts (each rank's workers would fill
    a buffer of its own, and the mesh needs the same rows on every rank)."""
    procs, outs = _cli_ranks(tmp_path, "overrides.num_env_workers=2")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode != 0
        assert f"process group: rank {r} of 2, backend gloo" in out
        assert "num_env_workers=2 with parallel=mesh over 2 processes" in out, out[-3000:]


def test_cli_joins_a_group_of_two(tmp_path):
    """``python -m mbrl_tpu_torch.examples.main`` with the variables set, two
    processes, ``parallel=mesh`` with the data axis two wide, a small PETS
    budget on the CPU: both join over gloo, each writes its own run
    directory, and both end with the same model."""
    procs, outs = _cli_ranks(tmp_path)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"process group: rank {r} of 2, backend gloo" in out
    runs = sorted(tmp_path.rglob("model.pkl"))
    assert [p.parent.name for p in runs] == ["rank0", "rank1"]
    models = []
    for path in runs:
        with open(path, "rb") as f:
            models.append(pickle.load(f))
        assert (path.parent / "results.csv").exists() and (path.parent / "config.yaml").exists()
    for a, b in zip(models[0]["params"]["layers"], models[1]["params"]["layers"]):
        assert all(np.array_equal(a[k], b[k]) for k in a)
