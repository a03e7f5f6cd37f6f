"""The ``parallel:`` config group's sharding context (counterpart of
``mbrl_tpu/parallel/context.py``): the bridge from config to the mesh of
:mod:`mbrl_tpu_torch.parallel.mesh`.

  - ensemble members train in blocks over the mesh's ``model`` axis;
  - rollout particles and training rows split over the ``data`` axis;
  - the collectives are explicit: the trainer sums gradients over ``data``
    (and, for the leaves every member shares, over ``model``), ``ModelEnv``
    gathers the particles' returns, the trainer the epoch's losses and scores.

Between retrainings the model state is whole on every rank: a rollout step
runs each rank's block of the elites on the particle rows they serve
(``models/gaussian_mlp.py:GaussianMLP._forward_split``), and the trainer
takes each rank's block of members inside a call
(``models/trainer.py:_MeshPlan``).

Select with ``parallel=mesh`` on the CLI (config group
``examples/conf/parallel/``), or construct directly for library use.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from mbrl_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, Sharding, make_mesh, replicate, shard_ensemble_params,
)


class ParallelContext:
    """Holds the mesh and the sharding policy knobs from config."""

    def __init__(
        self,
        mesh: Mesh,
        shard_particles: bool = True,
        shard_training: bool = True,
    ):
        self.mesh = mesh
        self.shard_particles = shard_particles
        self.shard_training = shard_training

    # ------------------------------------------------------------------ #
    def particle_sharding(self) -> Optional[Sharding]:
        """Sharding of the flat particle/population axis of planning and
        imagined rollouts (``ModelEnv``'s ``particle_sharding``)."""
        if not self.shard_particles:
            return None
        return Sharding(self.mesh, (DATA_AXIS,))

    def row_sharding(self) -> Sharding:
        """(N, ...) row batches split over the data axis."""
        return Sharding(self.mesh, (DATA_AXIS,))

    def member_batch_sharding(self) -> Sharding:
        """(E, B, ...) bootstrapped batches: members over model, rows over data."""
        return Sharding(self.mesh, (MODEL_AXIS, DATA_AXIS))

    def replicated(self) -> Sharding:
        return Sharding(self.mesh, ())

    # ------------------------------------------------------------------ #
    def shard_model_state(self, ensemble_size: int, state: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's placement of a TransitionRewardModel state: its block of
        the members of every member leaf (``mesh.ensemble_param_sharding``),
        the normalizer statistics as rank 0 holds them."""
        out = {**state, "params": shard_ensemble_params(state["params"], self.mesh, ensemble_size)}
        if state.get("normalizer") is not None:
            out["normalizer"] = replicate(state["normalizer"], self.mesh)
        return out

    def shard_dataset(self, dataset) -> None:
        """Check that every rank holds the same rows of a
        ``DeviceTransitionDataset``: the ranks draw each minibatch of the whole
        dataset alike and keep their block of its rows, so the dataset itself
        stays whole on every rank. Raises when the ranks' datasets differ."""
        if not self.shard_training or dataset.data is None or self.mesh.size == 1:
            return
        n = min(int(dataset.num_stored), dataset.capacity)
        sums = torch.stack([x[:n].double().sum() for x in dataset.data.astuple()]
                           + [torch.tensor(float(n), dtype=torch.float64, device=dataset.device)])
        differs = (self.mesh.broadcast(sums.clone()) != sums).any().double()[None]
        if self.mesh.all_reduce(differs).item():  # every rank raises, or none
            raise ValueError("the ranks hold different datasets; a mesh needs the same rows on "
                             "every rank (seed every rank's run alike)")


def make_parallel_context(cfg) -> Optional[ParallelContext]:
    """A ParallelContext from the ``parallel:`` config group (None when the
    group is absent or disabled)."""
    pcfg = cfg.get("parallel", None) if hasattr(cfg, "get") else None
    if pcfg is None or not pcfg.get("enable", False):
        return None
    mesh = make_mesh(model_axis_size=pcfg.get("model_axis_size", None))
    return ParallelContext(
        mesh,
        shard_particles=bool(pcfg.get("shard_particles", True)),
        shard_training=bool(pcfg.get("shard_training", True)),
    )
