"""The port's (model, data) mesh on ``torch.distributed`` (CPU, gloo):
``parallel/mesh.py``, ``parallel/context.py`` and the two seams,
``ModelEnv(particle_sharding=...)`` and ``ModelTrainer(parallel_ctx=...)``.

- One process: the mesh is 1 x 1 and creates no process group, and every
  sharded run equals the unsharded one exactly (``torch.equal``): a training
  step, planning on both paths, and ``pets.train``, ``mbpo.train`` and
  ``planet.train`` with ``parallel=mesh``.
- Four gloo ranks (model 2 x data 2) at ``tests/test_parallel.py``'s sizes
  (E = 8, B = 16, 2 x 32 silu, normalizer on) on weights carried across from
  the JAX state: the loss within rtol 1e-5 and every gradient within rtol
  1e-4, atol 1e-5 of the JAX replicated step and of the JAX step on the
  8-device mesh; planning on the generic path within rtol 1e-4, atol 1e-5 of
  the unsharded values.
- Two gloo ranks (data 2): the fast path's sharded returns against the
  unsharded ones, statistically (equal means within 5 standard errors, no
  inflated variance) on both kernel routes, with no noise stream repeated
  across ranks; PlaNet's loss and gradients over windows split by row, and
  ``planet.train`` with ``parallel.model_axis_size=1``.
"""
import multiprocessing as mp
import pathlib
import pickle
import socket
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mbrl_tpu.models import GaussianMLP as JaxGaussianMLP
from mbrl_tpu.models import TransitionRewardModel as JaxTRM
from mbrl_tpu.ops import normalizer as jax_normalizer
from mbrl_tpu.ops.tree import combine_params, partition_params
from mbrl_tpu.parallel import mesh as jax_mesh
from mbrl_tpu.types import TransitionBatch as JaxTransitionBatch
from mbrl_tpu_torch import convert
from mbrl_tpu_torch.envs.termination_fns import no_termination
from mbrl_tpu_torch.models import GaussianMLP, ModelEnv, ModelTrainer, TransitionRewardModel
from mbrl_tpu_torch.ops.tree import tree_leaves_with_path
from mbrl_tpu_torch.parallel import (
    DATA_AXIS, MODEL_AXIS, ParallelContext, ensemble_param_sharding, make_mesh,
    make_parallel_context, run_multihost_dryrun, shard_ensemble_params, shard_member_batch,
    shard_particles,
)
from mbrl_tpu_torch.parallel.mesh import Mesh, Sharding
from mbrl_tpu_torch.types import TransitionBatch

OBS, ACT, E, B, HID = 4, 2, 8, 16, 32
POP, HORIZON, PARTICLES = 16, 5, 4
CLIP = 0.5  # a gradient norm below the case's: every step clips


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while these tests run: the test workers share the
    CPU, and a pool of threads per worker over small products slows them all
    many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        queue.put((rank, fn(*args), None))
    except Exception:  # reported to the parent, which fails the test
        queue.put((rank, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 240.0):
    """``fn(*args)`` on ``world`` spawned gloo ranks (CPU); their results in
    rank order."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, fn, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = [queue.get(timeout=timeout) for _ in range(world)]
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    errors = [err for _, _, err in got if err]
    assert not errors, errors[0]
    return [out for _, out, _ in sorted(got, key=lambda g: g[0])]


# --------------------------------------------------------------------------- #
# One process
# --------------------------------------------------------------------------- #
def test_make_mesh_without_a_group_is_one_by_one():
    mesh = make_mesh()
    assert mesh.shape == {MODEL_AXIS: 1, DATA_AXIS: 1} and mesh.size == 1
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(devices=["cuda:0", "cuda:1"])
    t = torch.arange(3.0)
    assert mesh.all_reduce(t) is t and mesh.gather(t, DATA_AXIS) is t


def test_sharding_rules_on_a_two_by_two_mesh():
    """Rank 3 of model 2 x data 2: E = 8 splits its member leaves, E = 7 keeps
    them whole (the axis does not divide it), integer leaves stay whole."""
    mesh = Mesh(2, 2, rank=3)
    assert mesh.coords == {MODEL_AXIS: 1, DATA_AXIS: 1}
    params = {"w": torch.arange(8 * 3.0).reshape(8, 3), "elite": torch.arange(8),
              "bound": torch.zeros(1, 3)}
    rule = ensemble_param_sharding(mesh, 8)
    assert rule(params["w"]).spec == (MODEL_AXIS,) and rule(params["elite"]).spec == ()
    local = shard_ensemble_params(params, mesh, 8)
    assert torch.equal(local["w"], params["w"][4:]) and torch.equal(local["elite"], params["elite"])
    seven = {"w": torch.zeros(7, 3)}
    assert ensemble_param_sharding(mesh, 7)(seven["w"]).spec == ()
    assert shard_ensemble_params(seven, mesh, 7)["w"].shape == (7, 3)
    batch = np.arange(8 * 16).reshape(8, 16)
    assert np.array_equal(shard_member_batch({"x": batch}, mesh)["x"], batch[4:, 8:])
    assert np.array_equal(shard_particles(np.arange(10), Mesh(1, 2, rank=1)), np.arange(5, 10))
    with pytest.raises(ValueError, match="does not divide"):
        shard_particles(np.arange(9), Mesh(1, 2, rank=1))
    # the context's placements: members over model, the rest whole
    pctx = ParallelContext(mesh)
    placed = pctx.shard_model_state(8, {"params": params, "normalizer": None})
    assert torch.equal(placed["params"]["w"], params["w"][4:]) and placed["normalizer"] is None
    assert torch.equal(placed["params"]["bound"], params["bound"])
    assert pctx.row_sharding().spec == (DATA_AXIS,) and pctx.replicated().spec == ()
    assert pctx.particle_sharding().parts == 2 and pctx.member_batch_sharding().parts == 4


def _pair(seed=0):
    common = dict(in_size=OBS + ACT, out_size=OBS + 1, num_layers=2, ensemble_size=E,
                  hid_size=HID, activation="silu", propagation_method="random_model")
    wkw = dict(target_is_delta=True, normalize=True, learned_rewards=True)
    jw = JaxTRM(JaxGaussianMLP(**common), **wkw)
    jstate = jw.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    data = (rng.standard_normal((64, OBS + ACT)) * 2 + 0.5).astype(np.float32)
    jstate["normalizer"] = jax_normalizer.update_stats(jstate["normalizer"], jnp.asarray(data))
    host = jax.tree_util.tree_map(np.asarray, jstate)
    host_state = {"params": host["params"],
                  "normalizer": {"mean": host["normalizer"].mean, "std": host["normalizer"].std}}
    return jw, jstate, common, wkw, host_state


def _batch_arrays(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(E, B, OBS), f(E, B, ACT), f(E, B, OBS), f(E, B, 1),
            np.zeros((E, B, 1), bool), np.zeros((E, B, 1), bool))


def _port(common, wkw, host_state):
    tw = TransitionRewardModel(GaussianMLP(device="cpu", **common), **wkw)
    return tw, convert.convert_state(host_state, "cpu")


def _one_by_one():
    return ParallelContext(make_mesh())


def test_world_one_training_step_equals_unsharded():
    _, _, common, wkw, host_state = _pair()
    tw, state = _port(common, wkw, host_state)
    batch = TransitionBatch(*_batch_arrays())
    loss, grads = ModelTrainer(tw).loss_and_grads(state, batch)
    loss_m, grads_m = ModelTrainer(tw, parallel_ctx=_one_by_one()).loss_and_grads(state, batch)
    assert torch.equal(loss, loss_m) and grads.keys() == grads_m.keys()
    assert all(torch.equal(grads[k], grads_m[k]) for k in grads)


@pytest.mark.parametrize("fast", [True, False], ids=["fast_path", "generic_path"])
def test_world_one_planning_equals_unsharded(fast):
    _, _, common, wkw, host_state = _pair()
    tw, state = _port(common, wkw, host_state)
    tw.model.supports_fast_rollout = fast
    seqs = np.random.default_rng(1).uniform(-1, 1, (POP, HORIZON, ACT)).astype(np.float32)
    values = [
        ModelEnv(tw, no_termination, particle_sharding=sh).evaluate_action_sequences(
            state, seqs, np.zeros(OBS, np.float32), torch.Generator().manual_seed(2),
            num_particles=PARTICLES)
        for sh in (None, _one_by_one().particle_sharding())
    ]
    assert torch.equal(values[0], values[1])


class _RankOfTwo(Mesh):
    """Rank ``rank`` of a 1 x 2 mesh in this process: rank 0's all-reduces
    keep its parts in ``parts``, rank 1's add them in the same order, so rank
    1 returns what both ranks would after each all-reduce."""

    def __init__(self, rank: int, parts: list):
        super().__init__(1, 2, rank)
        self.parts, self.calls = parts, 0

    def all_reduce(self, tensor, axes=(MODEL_AXIS, DATA_AXIS)):
        if self.rank == 0:
            self.parts.append(tensor.clone())
            return tensor
        self.calls += 1
        return tensor + self.parts[self.calls - 1]


@pytest.mark.parametrize("method,batch", [
    ("random_model", 16), ("random_model", 10), ("fixed_model", 16), ("fixed_model", 10),
    ("expectation", 16)])
def test_split_rollout_step_equals_unsharded_and_splits_the_work(method, batch, monkeypatch):
    """A rollout step split over a data axis of 2: the whole batch's mean and
    log-variance equal the unsharded step's. With an equal shard for each of
    the 5 elites (B = 10), rank 0 runs elites 0-1 and rank 1 elites 2-4, each
    on its own shard through K3; otherwise each rank runs its half of the
    rows through every elite. Rows the unsharded step gives K3: B."""
    from mbrl_tpu_torch.ops import kernels

    model = GaussianMLP(OBS + ACT, OBS + 1, num_layers=2, ensemble_size=6, hid_size=16,
                        propagation_method=method, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    params["elite"] = torch.tensor([0, 2, 3, 4, 5])
    x = torch.randn((batch, OBS + ACT), generator=torch.Generator().manual_seed(4))
    indices = model.sample_propagation_indices(batch, torch.Generator().manual_seed(5))
    k3_shapes = []
    k3 = kernels.fused_ensemble_mlp

    def counted(h, stack, tiles=None):
        k3_shapes.append(tuple(h.shape))
        return k3(h, stack, tiles=tiles)

    monkeypatch.setattr(kernels, "fused_ensemble_mlp", counted)

    def step(sharding):
        return model.forward_propagated(params, x, torch.Generator().manual_seed(6),
                                        propagation_indices=indices, sharding=sharding)

    want = step(None)
    unsharded_k3 = list(k3_shapes)
    k3_shapes.clear()
    parts: list = []
    step(Sharding(_RankOfTwo(0, parts), (DATA_AXIS,)))
    got = step(Sharding(_RankOfTwo(1, parts), (DATA_AXIS,)))
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    if method != "expectation" and batch % 5 == 0:
        assert unsharded_k3 == [(5, batch // 5, OBS + ACT)]
        assert k3_shapes == [(2, batch // 5, OBS + ACT), (3, batch // 5, OBS + ACT)]
    else:
        assert k3_shapes == [] and len(parts) == 1


def _run_pets(tmp, mesh: bool):
    from test_torch_pets import MockLineEnv, _pets_cfg, mock_reward_fn, mock_term_fn
    import mbrl_tpu_torch.algorithms.pets as pets

    cfg = _pets_cfg(("parallel=mesh",) if mesh else ())
    cfg.overrides["num_steps"] = 40
    cfg.algorithm["dataset_size"] = 1000
    cfg.dynamics_model["hid_size"] = 16
    return pets.train(MockLineEnv(), mock_term_fn, mock_reward_fn, cfg, silent=False,
                      work_dir=str(tmp), device="cpu")


def _run_mbpo(tmp, mesh: bool):
    from test_torch_mbpo import MockLineEnv, _mock_term_fn, _small_cfg
    import mbrl_tpu_torch.algorithms.mbpo as mbpo

    cfg = _small_cfg()
    if mesh:
        cfg["parallel"] = {"enable": True, "model_axis_size": None}
    return mbpo.train(MockLineEnv(), MockLineEnv(), _mock_term_fn, cfg, work_dir=str(tmp),
                      device="cpu")


def _run_planet(tmp, mesh: bool):
    from test_torch_planet import MockPixelEnv
    from test_torch_planet_algorithm import _planet_cfg
    from mbrl_tpu_torch.algorithms import planet

    top = {"parallel": {"enable": True, "model_axis_size": 1}} if mesh else {}
    return planet.train(MockPixelEnv(), _planet_cfg(**top), silent=False, work_dir=str(tmp),
                        device="cpu")


def _saved(tmp: pathlib.Path):
    """Every pickled model and csv a run wrote, by name."""
    out = {}
    for path in sorted(tmp.iterdir()):
        if path.suffix == ".pkl":
            with open(path, "rb") as f:
                out[path.name] = pickle.load(f)
        elif path.suffix == ".csv":
            out[path.name] = path.read_text()
    return out


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, torch.Tensor)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


@pytest.mark.parametrize("run", [_run_pets, _run_mbpo, _run_planet], ids=["pets", "mbpo", "planet"])
def test_world_one_algorithms_with_parallel_mesh_equal_unsharded(run, tmp_path):
    """``parallel=mesh`` on one process: the same best reward, and the same
    saved model, logs and results, as the unsharded run."""
    (tmp_path / "none").mkdir()
    (tmp_path / "mesh").mkdir()
    plain, meshed = run(tmp_path / "none", False), run(tmp_path / "mesh", True)
    assert np.isfinite(plain) and plain == meshed
    a, b = _saved(tmp_path / "none"), _saved(tmp_path / "mesh")
    assert a.keys() == b.keys() and any(k.endswith(".pkl") for k in a)
    for k in a:
        assert _equal(a[k], b[k]), k


def test_mesh_yaml_is_the_jax_group():
    import yaml

    root = pathlib.Path(__file__).resolve().parent.parent
    trees = [yaml.safe_load((root / pkg / "examples/conf/parallel/mesh.yaml").read_text())
             for pkg in ("mbrl_tpu", "mbrl_tpu_torch")]
    assert trees[0] == trees[1] == {"enable": True, "model_axis_size": None,
                                    "shard_particles": True, "shard_training": True}


def test_parallel_context_from_config():
    assert make_parallel_context({"parallel": {"enable": False}}) is None
    pctx = make_parallel_context({"parallel": {"enable": True, "model_axis_size": None,
                                               "shard_particles": False}})
    assert pctx.mesh.size == 1 and pctx.particle_sharding() is None
    assert pctx.member_batch_sharding().spec == (MODEL_AXIS, DATA_AXIS)


# --------------------------------------------------------------------------- #
# Four gloo ranks: model 2 x data 2
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def four_ranks():
    jw, jstate, common, wkw, host_state = _pair()
    arrays = _batch_arrays()
    seqs = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (POP, HORIZON, ACT),
                                         minval=-1, maxval=1), np.float32)
    case = {"model": common, "wrapper": wkw, "state": host_state, "batch": arrays,
            "model_axis_size": 2,
            "train": {"batch_size": B, "val_ratio": 0.25, "epochs": 3, "seed": 4},
            "train_clipped": {"batch_size": B, "val_ratio": 0.25, "epochs": 3, "seed": 4,
                              "grad_clip_norm": CLIP},
            "plan": {"sequences": seqs, "initial_obs": np.zeros(OBS, np.float32),
                     "num_particles": PARTICLES, "seed": 2, "fast_rollout": False}}
    results = run_multihost_dryrun(4, timeout_s=240, device="cpu", case=case)
    return jw, jstate, common, wkw, host_state, arrays, case, results


def _jax_loss_and_grads(jw, jstate, arrays, mesh=None):
    batch = JaxTransitionBatch(*arrays)

    def loss_fn(diff, static, normalizer, batch):
        loss, _ = jw.loss({"params": combine_params(diff, static), "normalizer": normalizer},
                          batch)
        return loss

    diff, static = partition_params(jstate["params"])
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    if mesh is None:
        loss, grads = grad_fn(diff, static, jstate["normalizer"], batch)
    else:
        with mesh:
            loss, grads = grad_fn(jax_mesh.shard_ensemble_params(diff, mesh, E), static,
                                  jax_mesh.replicate(jstate["normalizer"], mesh),
                                  jax_mesh.shard_member_batch(batch, mesh))
    return float(loss), grads


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) else tree[key]
    return np.asarray(tree)


@pytest.mark.parametrize("reference", ["replicated", "mesh8"])
def test_four_ranks_training_step_matches_jax(four_ranks, reference):
    jw, jstate, _, _, _, arrays, _, results = four_ranks
    assert [r["mesh"] for r in results] == [{MODEL_AXIS: 2, DATA_AXIS: 2}] * 4
    mesh = jax_mesh.make_mesh(jax.devices(), model_axis_size=2) if reference == "mesh8" else None
    loss, grads = _jax_loss_and_grads(jw, jstate, arrays, mesh)
    for r in results:
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        assert r["grads"]  # every trainable leaf
        for path, g in r["grads"].items():
            np.testing.assert_allclose(g, _leaf(grads, path), rtol=1e-4, atol=1e-5,
                                       err_msg=path)


def test_four_ranks_train_device_matches_one_process(four_ranks):
    """Three epochs of ``train_device`` on the case's 128 rows: each rank
    trains its 4 members on its 8 rows of every 16-row batch, the scores
    gathered for early stopping and elites. The losses and scores agree with
    one process's to 1e-5; the weights to 1e-5, Adam's steps dividing
    gradients that differ in summation order only."""
    _, _, common, wkw, host_state, arrays, case, results = four_ranks
    tw, state = _port(common, wkw, host_state)
    from mbrl_tpu_torch.util.device_buffer import DeviceTransitionDataset
    from mbrl_tpu_torch.util.replay_buffer import ReplayBuffer

    rows = [x.reshape((-1,) + x.shape[2:]) for x in arrays]
    buffer = ReplayBuffer(len(rows[0]), (OBS,), (ACT,))
    buffer.add_batch(rows[0], rows[1], rows[2], rows[3].reshape(-1), rows[4].reshape(-1),
                     rows[5].reshape(-1))
    dataset = DeviceTransitionDataset(OBS, ACT, device="cpu")
    dataset.sync_from(buffer)
    train = case["train"]
    new, losses, vals = ModelTrainer(tw).train_device(
        state, dataset, batch_size=train["batch_size"], val_ratio=train["val_ratio"],
        num_epochs=train["epochs"], generator=torch.Generator().manual_seed(train["seed"]))
    params = {"/".join(map(str, k)): v.numpy() for k, v in tree_leaves_with_path(new["params"])}
    for r in results:
        np.testing.assert_allclose(r["train_losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["train_vals"], vals, rtol=1e-5)
        assert r["train_params"].keys() == params.keys()
        for k, v in params.items():
            np.testing.assert_allclose(r["train_params"][k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_four_ranks_clipped_train_device_matches_one_process(four_ranks, monkeypatch):
    """The same ``train_device`` call with the gradients clipped to a norm of
    0.5: each rank's norm is the whole gradient's (its members' squares summed
    over the model axis), so every rank clips as one process does."""
    from mbrl_tpu_torch.parallel.multihost import train_on_batch

    _, _, common, wkw, host_state, arrays, case, results = four_ranks
    tw, state = _port(common, wkw, host_state)
    norms = []
    clip = torch.nn.utils.clip_grad_norm_

    def recorded(leaves, max_norm):
        norms.append(clip(leaves, max_norm))
        return norms[-1]

    monkeypatch.setattr(torch.nn.utils, "clip_grad_norm_", recorded)
    new, losses, vals = train_on_batch(ModelTrainer(tw), state, arrays, case["train_clipped"],
                                       torch.device("cpu"))
    assert norms and min(map(float, norms)) > CLIP  # every step of one process clipped
    params = {"/".join(map(str, k)): v.numpy() for k, v in tree_leaves_with_path(new["params"])}
    for r in results:
        np.testing.assert_allclose(r["train_clipped_losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["train_clipped_vals"], vals, rtol=1e-5)
        assert r["train_clipped_params"].keys() == params.keys()
        for k, v in params.items():
            np.testing.assert_allclose(r["train_clipped_params"][k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_four_ranks_planning_matches_unsharded(four_ranks):
    _, _, common, wkw, host_state, _, case, results = four_ranks
    tw, state = _port(common, wkw, host_state)
    tw.model.supports_fast_rollout = False
    plan = case["plan"]
    plain = ModelEnv(tw, no_termination).evaluate_action_sequences(
        state, plan["sequences"], plan["initial_obs"], torch.Generator().manual_seed(plan["seed"]),
        num_particles=plan["num_particles"]).numpy()
    for r in results:
        np.testing.assert_allclose(r["plan_values"], plain, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------- #
# Two gloo ranks: data 2
# --------------------------------------------------------------------------- #
FAST_POP, FAST_H, FAST_PARTICLES, FAST_KEYS = 8, 5, 16, 32


def _fast_model(shuffle: str):
    model = GaussianMLP(OBS + ACT, OBS + 1, num_layers=2, ensemble_size=4, hid_size=16,
                        propagation_method="random_model", rollout_shuffle=shuffle, device="cpu")
    tw = TransitionRewardModel(model, target_is_delta=True, normalize=False, learned_rewards=True)
    return tw, tw.init(torch.Generator().manual_seed(7))


def _fast_inputs():
    rng = np.random.default_rng(1)
    return (0.3 * rng.standard_normal((FAST_POP, FAST_H, ACT))).astype(np.float32), \
        0.5 * np.ones(OBS, np.float32)


def _fast_sweep(env, state, seqs, obs0):
    return np.stack([
        env.evaluate_action_sequences(state, seqs, obs0, torch.Generator().manual_seed(100 + k),
                                      num_particles=FAST_PARTICLES).numpy()
        for k in range(FAST_KEYS)])


def _planet_case():
    from test_torch_planet import SMALL
    from mbrl_tpu_torch.models import PlaNetModel

    model = PlaNetModel(**SMALL, device="cpu")
    state = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    windows, length = 4, 5
    obs = rng.integers(0, 256, (windows, length) + tuple(SMALL["obs_shape"]), dtype=np.uint8)
    act = rng.uniform(-1, 1, (windows, length, SMALL["action_size"])).astype(np.float32)
    rewards = rng.standard_normal((windows, length)).astype(np.float32)
    flags = np.zeros((windows, length), bool)
    return model, state, TransitionBatch(obs, act, obs, rewards, flags, flags)


def _two_ranks_job(work_root: str):
    """Everything the two-rank tests read, in one start of two processes."""
    pctx = ParallelContext(make_mesh(model_axis_size=1))
    rank = dist.get_rank()
    out = {"mesh": dict(pctx.mesh.shape)}
    seqs, obs0 = _fast_inputs()
    for shuffle in ("rotate", "sort"):
        tw, state = _fast_model(shuffle)
        env = ModelEnv(tw, no_termination, particle_sharding=pctx.particle_sharding())
        out[f"fast_{shuffle}"] = _fast_sweep(env, state, seqs, obs0)
        same = np.repeat(seqs[:1], FAST_POP, axis=0)
        out[f"same_{shuffle}"] = env.evaluate_action_sequences(
            state, same, obs0, torch.Generator().manual_seed(5),
            num_particles=FAST_PARTICLES).numpy()
    model, state, batch = _planet_case()
    loss, grads = ModelTrainer(model, parallel_ctx=pctx).loss_and_grads(
        state, batch, generator=torch.Generator().manual_seed(3))
    out["planet_loss"] = float(loss)
    out["planet_grads"] = {"/".join(map(str, k)): v.numpy() for k, v in grads.items()}
    work = pathlib.Path(work_root) / f"rank{rank}"
    work.mkdir()
    from test_torch_planet import MockPixelEnv
    from test_torch_planet_algorithm import _planet_cfg
    from mbrl_tpu_torch.algorithms import planet

    cfg = _planet_cfg(parallel={"enable": True, "model_axis_size": 1})
    out["planet_train"] = float(planet.train(MockPixelEnv(), cfg, silent=False,
                                             work_dir=str(work), device="cpu"))
    out["planet_saved"] = _saved(work)
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(_two_ranks_job, 2, str(tmp_path_factory.mktemp("two_ranks")))


@pytest.mark.parametrize("shuffle", ["rotate", "sort"], ids=["K1_route", "K2_route"])
def test_two_ranks_fast_path_agrees_statistically(two_ranks, shuffle):
    """The sharded fast path (each rank a block of the sequences, K1 or K2 on
    its rows, a generator of its own) against the unsharded one over 32
    generators: equal means within 5 standard errors, variance not inflated;
    the ranks gathered the same values. With every sequence the same, the two
    blocks differ: the ranks' noise streams do not repeat each other."""
    assert two_ranks[0]["mesh"] == {MODEL_AXIS: 1, DATA_AXIS: 2}
    sharded = two_ranks[0][f"fast_{shuffle}"]
    assert np.array_equal(sharded, two_ranks[1][f"fast_{shuffle}"])
    tw, state = _fast_model(shuffle)
    seqs, obs0 = _fast_inputs()
    plain = _fast_sweep(ModelEnv(tw, no_termination), state, seqs, obs0)
    se = np.sqrt((sharded.var(0) + plain.var(0)) / FAST_KEYS) + 1e-6
    np.testing.assert_array_less(np.abs(sharded.mean(0) - plain.mean(0)), 5.0 * se + 1e-3)
    assert float(sharded.var(0).mean()) <= 1.5 * float(plain.var(0).mean()) + 1e-6
    same = two_ranks[0][f"same_{shuffle}"]
    half = FAST_POP // 2
    assert np.isfinite(same).all() and not np.array_equal(same[:half], same[half:])


def test_two_ranks_planet_loss_and_gradients_match_one_process(two_ranks):
    model, state, batch = _planet_case()
    loss, grads = ModelTrainer(model).loss_and_grads(
        state, batch, generator=torch.Generator().manual_seed(3))
    for r in two_ranks:
        np.testing.assert_allclose(r["planet_loss"], float(loss), rtol=1e-5)
        assert r["planet_grads"].keys() == {"/".join(map(str, k)) for k in grads}
        for k, g in grads.items():
            np.testing.assert_allclose(r["planet_grads"]["/".join(map(str, k))], g.numpy(),
                                       rtol=1e-4, atol=1e-5)


def test_two_ranks_planet_train_end_to_end(two_ranks):
    """``planet.train`` with ``parallel=mesh`` and ``model_axis_size=1`` on two
    ranks: finite, and both ranks hold the same RSSM, logs and results."""
    a, b = two_ranks
    assert np.isfinite(a["planet_train"]) and a["planet_train"] == b["planet_train"]
    assert a["planet_saved"].keys() == b["planet_saved"].keys()
    assert any(k.endswith(".pkl") for k in a["planet_saved"])
    for k in a["planet_saved"]:
        assert _equal(a["planet_saved"][k], b["planet_saved"][k]), k
