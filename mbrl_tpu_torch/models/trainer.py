"""Dynamics-model training loop with per-member early stopping and elites
(counterpart of ``mbrl_tpu/models/trainer.py``).

Adam with coupled weight decay, a per-epoch update loop, un-bootstrapped
per-member validation, any-member relative-improvement early stopping with
patience, best-weights snapshot, elite selection, train/epoch/batch callbacks.

PyTorch is eager and its tensors are mutable, which shapes three things here:

  - the trainer works on its own copy of the trainable leaves (cloned at the
    start of a call, updated in place by ``torch.optim.Adam``). The state handed
    in is never written, so an agent may go on planning with it, and the state
    handed back holds fresh detached tensors that no optimizer will touch;
  - the best-weights snapshot is a clone, taken when an epoch improved;
  - an epoch is a Python loop of small launches. Its losses are read back once
    per epoch, not once per step.

With a ``parallel_ctx`` of more than one rank, a call splits over the mesh
(:class:`_MeshPlan`): each rank trains its block of members on its block of
every batch's rows, and the gradients are summed across the ranks. On one rank
a call is that of an unsharded trainer, operation for operation.

``train`` takes host iterators (re-stacked every epoch); ``train_device`` keeps
the dataset on the device (``util.device_buffer.DeviceTransitionDataset``) and
draws the split, the bootstrap and the batch order there;
``train_device_sequences`` (PlaNet) draws trajectory windows from such a
dataset of uint8 pixels. A model with ``stochastic_loss`` gets the call's
generator in ``loss``; a model with a ``precision()`` context (PlaNet's full
float32) has its losses and their backward passes run inside it.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mbrl_tpu_torch.device import rand, randint, randperm
from mbrl_tpu_torch.ops.tree import tree_leaves_with_path, tree_set
from mbrl_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from mbrl_tpu_torch.types import TransitionBatch


class DivergenceError(RuntimeError):
    """Model training produced non-finite losses/scores: the loop fails loudly
    instead of training, checkpointing and resuming a dead model."""


def _require_finite(name: str, arr, context: str = "") -> None:
    arr = np.asarray(arr, dtype=np.float64)
    if arr.size and not np.isfinite(arr).all():
        bad = int((~np.isfinite(arr)).sum())
        raise DivergenceError(
            f"non-finite {name} ({bad}/{arr.size} values) detected during model "
            f"training{'; ' + context if context else ''} — aborting instead of "
            "propagating a diverged model (first values: "
            f"{arr.reshape(-1)[:4].tolist()})"
        )


class _MeshPlan:
    """How a training call splits over a mesh of more than one rank (the
    counterpart of the JAX trainer's ``_maybe_shard_stacked``).

    Every rank draws the randomness of the whole call (split, bootstrap,
    batch order, a stochastic loss's noise), so the ranks agree on every
    batch and each keeps its block: its members along ``model`` when the axis
    divides the ensemble and the model's loss is a sum of per-member terms
    (``mesh_members``), and its rows along ``data`` when the axis divides the
    batch and the model's loss takes ``rows`` (``mesh_rows``). A loss over a
    block of rows is normalised by the whole batch's rows; the gradients are
    summed over ``data`` (the rows) and, for the leaves every member shares,
    over ``model``; each rank steps Adam on its own members. What a model
    cannot split is computed whole on every rank."""

    def __init__(self, mesh: Mesh, model):
        self.mesh = mesh
        self.ensemble_size = max(len(model), 1)
        m, d = mesh.shape[MODEL_AXIS], mesh.shape[DATA_AXIS]
        split_members = (m > 1 and self.ensemble_size % m == 0
                         and getattr(model, "mesh_members", False))
        self.member_block = mesh.block(self.ensemble_size, MODEL_AXIS) if split_members else None
        self.split_rows = d > 1 and getattr(model, "mesh_rows", False)
        # a loss of member terms (mesh_members) has a regularizer of the leaves
        # every member shares: one rank of the mesh adds it
        self.takes_regularize = getattr(model, "mesh_members", False)

    def is_member(self, leaf: torch.Tensor) -> bool:
        return (self.member_block is not None and leaf.ndim >= 1
                and leaf.shape[0] == self.ensemble_size)

    def split(self, batch: TransitionBatch, member_stacked: bool):
        """This rank's block of ``batch`` and the loss's keywords for it."""
        kw: Dict[str, Any] = {}
        members = slice(None)
        regularize = True
        if member_stacked and self.member_block is not None:
            members = self.member_block
            regularize = self.mesh.coords[MODEL_AXIS] == 0
        n = batch.obs.shape[1 if member_stacked else 0]
        rows = slice(None)
        if self.split_rows and n % self.mesh.shape[DATA_AXIS] == 0:
            rows = self.mesh.block(n, DATA_AXIS)
            kw["rows"] = (rows, n)
            regularize = regularize and self.mesh.coords[DATA_AXIS] == 0
        if self.takes_regularize:
            kw["regularize"] = regularize
        if member_stacked:
            return batch.map(lambda x: x[members][:, rows]), kw
        return batch.map(lambda x: x[rows]), kw

    def _axes(self, member: bool, rows_split: bool) -> Tuple[str, ...]:
        axes = (DATA_AXIS,) if rows_split else ()
        if self.member_block is not None and not member:
            axes += (MODEL_AXIS,)
        return axes

    def reduce_grads(self, leaves: List[torch.Tensor], members: List[bool],
                     rows_split: bool) -> None:
        """Sum the gradients over the ranks that computed parts of them: one
        all-reduce of the flattened gradients per set of axes."""
        by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for leaf, member in zip(leaves, members):
            if leaf.grad is not None:
                by_axes.setdefault(self._axes(member, rows_split), []).append(leaf.grad)
        for axes, grads in by_axes.items():
            if not axes:
                continue
            flat = self.mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), axes)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def reduce_losses(self, losses: torch.Tensor, rows_split: bool) -> torch.Tensor:
        """The whole batch's losses from each rank's part of them."""
        return self.mesh.all_reduce(losses.clone(), self._axes(False, rows_split))

    def reduce_metas(self, metas: List[Dict[str, Any]], rows_split: bool) -> List[Dict[str, Any]]:
        """Each step's meta summed like its loss; ``grad_norm`` is of the
        summed gradients already."""
        if not metas:
            return metas
        keys = [k for k in metas[0] if k != "grad_norm"]
        if not keys:
            return metas
        table = self.reduce_losses(
            torch.stack([torch.stack([m[k].float() for k in keys]) for m in metas]), rows_split)
        return [{**m, **dict(zip(keys, row))} for m, row in zip(metas, table)]


class _Work:
    """One call's trainable copy of the params, its optimizer and the paths of
    the trainable leaves. Under a mesh plan the member leaves hold this rank's
    block of members, and the gradients are summed over the mesh before each
    optimizer step."""

    def __init__(self, trainer: "ModelTrainer", state: Dict[str, Any]):
        params = state["params"]
        frozen = set(getattr(trainer.model, "frozen_param_keys", ()))
        self.plan: Optional[_MeshPlan] = trainer._plan
        self.paths = [
            path for path, leaf in tree_leaves_with_path(params)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and path[0] not in frozen
        ]
        self.leaves = []
        self.members: List[bool] = []  # per leaf: a block of members on this rank
        self.params = params
        for path in self.paths:
            leaf = params
            for key in path:
                leaf = leaf[key]
            member = self.plan is not None and self.plan.is_member(leaf)
            if member:
                leaf = leaf[self.plan.member_block]
            leaf = leaf.detach().clone().requires_grad_(True)
            self.leaves.append(leaf)
            self.members.append(member)
            self.params = tree_set(self.params, path, leaf)
        # one parameter group: the decay reaches every trainable leaf, biases too
        self.optimizer = torch.optim.Adam(
            self.leaves, lr=trainer.optim_lr, weight_decay=trainer.weight_decay,
            eps=trainer.optim_eps,
        )
        opt_state = state.get("opt_state")
        if opt_state is not None:
            opt_state = copy.deepcopy(opt_state)
            for i, entry in opt_state["state"].items():
                if isinstance(entry.get("step"), torch.Tensor):
                    entry["step"] = entry["step"].cpu()  # read on the host every step
                if self.members[i]:
                    for key in ("exp_avg", "exp_avg_sq"):
                        entry[key] = entry[key][self.plan.member_block]
            self.optimizer.load_state_dict(opt_state)
        self.normalizer = state.get("normalizer")
        self.clip_norm = getattr(trainer.model, "grad_clip_norm", None)

    def state(self) -> Dict[str, Any]:
        return {"params": self.params, "normalizer": self.normalizer}

    def snapshot(self) -> List[torch.Tensor]:
        return [leaf.detach().clone() for leaf in self.leaves]

    def _whole(self, i: int, leaf: torch.Tensor) -> torch.Tensor:
        """Leaf ``i`` with every member (gathered over the model axis)."""
        if not self.members[i]:
            return leaf
        return self.plan.mesh.gather(leaf.detach().contiguous(), MODEL_AXIS)

    def params_with(self, leaves: List[torch.Tensor]):
        """The params with ``leaves``, every member of them."""
        params = self.params
        for i, (path, leaf) in enumerate(zip(self.paths, leaves)):
            params = tree_set(params, path, self._whole(i, leaf.detach()))
        return params

    def opt_state(self):
        opt_state = copy.deepcopy(self.optimizer.state_dict())
        for i, entry in opt_state["state"].items():
            for key in ("exp_avg", "exp_avg_sq"):
                if key in entry:
                    entry[key] = self._whole(i, entry[key])
        return opt_state

    def backward(self, loss: torch.Tensor, rows_split: bool = False) -> None:
        """Every leaf's gradient of ``loss``, summed over the mesh's ranks."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.plan is not None:
            self.plan.reduce_grads(self.leaves, self.members, rows_split)

    def step(self, loss: torch.Tensor, want_norm: bool = False,
             rows_split: bool = False) -> Optional[torch.Tensor]:
        """One optimizer update from ``loss``; the pre-clip global gradient
        norm when clipping or ``want_norm``. ``rows_split``: the loss is of
        this rank's block of the batch's rows."""
        self.backward(loss, rows_split)
        norm = None
        if self.plan is not None and self.plan.member_block is not None:
            if self.clip_norm or want_norm:
                norm = self._split_norm()
            if self.clip_norm:  # as clip_grad_norm_ scales
                coef = torch.clamp(self.clip_norm / (norm + 1e-6), max=1.0)
                for leaf in self.leaves:
                    if leaf.grad is not None:
                        leaf.grad.mul_(coef)
        elif self.clip_norm:
            norm = torch.nn.utils.clip_grad_norm_(self.leaves, self.clip_norm)
        elif want_norm:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(l.grad) for l in self.leaves])
            )
        self.optimizer.step()
        return norm

    def _split_norm(self) -> torch.Tensor:
        """The whole gradient's norm when the members split over the model
        axis: the squares of this rank's member gradients summed over the
        axis, plus those of the leaves every member shares (whole here)."""
        own = torch.zeros((), device=self.leaves[0].device)
        shared = torch.zeros((), device=self.leaves[0].device)
        for leaf, member in zip(self.leaves, self.members):
            if leaf.grad is not None:
                sq = leaf.grad.float().square().sum()
                if member:
                    own = own + sq
                else:
                    shared = shared + sq
        own = self.plan.mesh.all_reduce(own[None], (MODEL_AXIS,))[0]
        return torch.sqrt(own + shared)


class ModelTrainer:
    """Trainer for TransitionRewardModel-wrapped ensembles."""

    _LOG_GROUP_NAME = "model_train"

    def __init__(
        self,
        model,
        optim_lr: float = 1e-4,
        weight_decay: float = 1e-5,
        optim_eps: float = 1e-8,
        logger=None,
        pad_epoch_to_multiple: int = 8,
        parallel_ctx=None,
    ):
        self.model = model
        self.parallel_ctx = parallel_ctx
        # how a call's work splits over the mesh; None on one rank, where the
        # calls are those of an unsharded trainer
        self._plan = (
            _MeshPlan(parallel_ctx.mesh, model)
            if parallel_ctx is not None and parallel_ctx.shard_training
            and parallel_ctx.mesh.size > 1
            else None
        )
        self.logger = logger
        self.optim_lr = optim_lr
        self.weight_decay = weight_decay
        self.optim_eps = optim_eps
        # Round the per-epoch minibatch count up to this multiple (cycling
        # batches from the epoch start), so that an epoch has as many gradient
        # steps as the JAX package's, whose epochs are padded for shape stability.
        self.pad_epoch_to_multiple = pad_epoch_to_multiple
        if logger is not None:
            logger.register_group(
                self._LOG_GROUP_NAME,
                [
                    ("train_iteration", "I", "int"),
                    ("epoch", "E", "int"),
                    ("train_dataset_size", "TD", "int"),
                    ("val_dataset_size", "VD", "int"),
                    ("model_loss", "MLOSS", "float"),
                    ("model_val_score", "MVSCORE", "float"),
                    ("model_best_val_score", "MBVSCORE", "float"),
                ],
                color="blue",
            )
        self._train_iteration = 0
        self._stochastic_loss = getattr(model, "stochastic_loss", False)
        self._precision = getattr(model, "precision", contextlib.nullcontext)

    def _loss(self, work: _Work, batch: TransitionBatch, generator: torch.Generator,
              member_stacked: bool = True):
        """The loss of ``batch`` and its meta, and whether it was of this
        rank's block of the batch's rows. Under a mesh plan the rank takes its
        members (``member_stacked``: (E, B, ...) leaves) and its rows of the
        batch; the loss is normalised by the whole batch's rows."""
        kw = {"generator": generator} if self._stochastic_loss else {}
        rows_split = False
        if work.plan is not None:
            batch, plan_kw = work.plan.split(batch, member_stacked)
            rows_split = "rows" in plan_kw
            kw.update(plan_kw)
        loss, meta = self.model.loss(work.state(), batch, **kw)
        return loss, meta, rows_split

    def loss_and_grads(
        self, state: Dict[str, Any], batch: TransitionBatch,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[Tuple, torch.Tensor]]:
        """One training step's loss of ``batch`` ((E, B, ...) leaves) and the
        gradient of every trainable leaf, by path, without the update. Under a
        mesh both are whole on every rank: the parts summed over the ranks and
        each member's gradient gathered over the model axis."""
        work = _Work(self, state)
        with self._precision():
            loss, _, rows_split = self._loss(work, batch, generator,
                                             member_stacked=batch.obs.ndim == 3)
            work.backward(loss, rows_split)
        loss = loss.detach()
        if work.plan is not None:
            loss = work.plan.reduce_losses(loss[None], rows_split)[0]
        return loss, {path: work._whole(i, leaf.grad)
                      for i, (path, leaf) in enumerate(zip(work.paths, work.leaves))}

    def _work_scores(self, work: _Work, batch: TransitionBatch) -> torch.Tensor:
        """Per-member validation scores (E,) of the work's weights: each rank
        scores its members on the whole batch, gathered over the model axis."""
        scores = self._scores(work.state(), batch)
        if work.plan is not None and work.plan.member_block is not None:
            scores = work.plan.mesh.gather(scores, MODEL_AXIS)
        return scores

    # ------------------------------------------------------------------ #
    def _scores(self, state, batch: TransitionBatch) -> torch.Tensor:
        """Per-member validation score: mean squared error over batch and
        output dim -> shape (E,)."""
        with torch.no_grad():
            score, _ = self.model.eval_score(state, batch)
            if score.ndim == 2:  # non-ensemble
                score = score[None]
            return score.mean(dim=(1, 2))

    # ------------------------------------------------------------------ #
    # Host-iterator path
    # ------------------------------------------------------------------ #
    @staticmethod
    def _improved_members(
        best: np.ndarray, current: np.ndarray, threshold: float
    ) -> np.ndarray:
        return ((best - current) / np.maximum(np.abs(best), 1e-12)) > threshold

    def train(
        self,
        state: Dict[str, Any],
        dataset_train,
        dataset_val=None,
        num_epochs: Optional[int] = None,
        patience: Optional[int] = None,
        improvement_threshold: float = 0.01,
        callback: Optional[Callable] = None,
        epoch_callback: Optional[Callable] = None,
        batch_callback: Optional[Callable] = None,
        evaluate: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, Any], List[float], List[float]]:
        """Train until num_epochs or patience epochs without >threshold improvement
        in ANY ensemble member's validation score.

        ``dataset_train`` may be an iterator (re-stacked each epoch to honor
        shuffling/bootstrap) or an already-stacked TransitionBatch.
        ``batch_callback(epoch, loss, meta, "train")`` gets each step's loss
        meta with its pre-clip ``grad_norm``. ``generator`` feeds a stochastic
        loss (default: seeded by the call's index).
        Returns (updated wrapper state with best params + elites, train losses,
        val scores).
        """
        from mbrl_tpu_torch.util.replay_buffer import TransitionIterator, stack_iterator

        update_from_iterator = isinstance(dataset_train, TransitionIterator)
        eval_iterator = dataset_val if dataset_val is not None else dataset_train
        dev = self.model.device
        if generator is None:
            generator = torch.Generator().manual_seed(self._train_iteration)

        work = _Work(self, state)
        # validation data: one stacked device batch (un-bootstrapped)
        val_batch = self._stack_eval(eval_iterator) if evaluate else None

        training_losses: List[float] = []
        val_scores: List[float] = []
        best_leaves = None  # None: the weights the call started from
        best_val_score = (
            self._work_scores(work, val_batch).cpu().numpy() if evaluate else None
        )
        epochs_since_update = 0
        epoch = 0
        while True:
            if num_epochs is not None and epoch >= num_epochs:
                break
            stacked = stack_iterator(dataset_train) if update_from_iterator else dataset_train
            stacked = self._pad_epoch(stacked).to(dev)
            losses, metas = [], []
            for i in range(len(stacked)):
                batch = stacked[i]
                with self._precision():
                    loss, meta, rows_split = self._loss(
                        work, batch, generator, member_stacked=batch.obs.ndim == 3)
                    norm = work.step(loss, want_norm=batch_callback is not None,
                                     rows_split=rows_split)
                losses.append(loss.detach())
                metas.append({**_detached(meta), "grad_norm": norm})
            batch_losses = torch.stack(losses)
            if work.plan is not None:
                batch_losses = work.plan.reduce_losses(batch_losses, rows_split)
                if batch_callback is not None:
                    metas = work.plan.reduce_metas(metas, rows_split)
            batch_losses = batch_losses.cpu().numpy()  # the epoch's one read-back
            train_loss = float(batch_losses.mean())
            _require_finite("train loss", train_loss, f"epoch {epoch}")
            training_losses.append(train_loss)
            if batch_callback is not None:
                for i, meta in enumerate(_host_metas(metas)):
                    batch_callback(epoch, float(batch_losses[i]), meta, "train")

            if not evaluate:
                epoch += 1
                if epoch_callback is not None:
                    epoch_callback(epoch, train_loss, None)
                continue

            member_scores = self._work_scores(work, val_batch).cpu().numpy()
            _require_finite("validation score", member_scores, f"epoch {epoch}")
            val_score = float(member_scores.mean())
            val_scores.append(val_score)

            improved = self._improved_members(best_val_score, member_scores, improvement_threshold)
            if improved.any():
                best_val_score = np.minimum(best_val_score, member_scores)
                best_leaves = work.snapshot()
                epochs_since_update = 0
            else:
                epochs_since_update += 1

            if self.logger is not None:
                self.logger.log_data(
                    self._LOG_GROUP_NAME,
                    {
                        "train_iteration": self._train_iteration,
                        "epoch": epoch,
                        "train_dataset_size": _dataset_size(dataset_train),
                        "val_dataset_size": _dataset_size(eval_iterator)
                        if dataset_val is not None
                        else 0,
                        "model_loss": train_loss,
                        "model_val_score": val_score,
                        "model_best_val_score": float(best_val_score.mean()),
                    },
                )
            if epoch_callback is not None:
                epoch_callback(epoch, train_loss, member_scores)
            if callback is not None:
                callback(
                    self.model, self._train_iteration, epoch, train_loss,
                    val_score, best_val_score.mean(),
                )

            epoch += 1
            if patience is not None and epochs_since_update >= patience:
                break

        # Restore best weights and pick elites by final per-member score. The
        # optimizer state is the FINAL step's moments: the optimizer keeps its
        # running moments while the weights are snapshot-restored.
        if not evaluate:
            best_params = work.params_with(work.leaves)
        elif best_leaves is None:
            best_params = state["params"]
        else:
            best_params = work.params_with(best_leaves)
        new_state = {**state, "params": best_params, "opt_state": work.opt_state()}
        if evaluate:
            final_scores = self._scores(
                {"params": best_params, "normalizer": work.normalizer}, val_batch
            ).cpu().numpy()
            num_elites = getattr(self.model, "num_elites", None)
            if final_scores.shape[0] > 1:
                order = np.argsort(final_scores)
                k = num_elites if num_elites else final_scores.shape[0]
                new_state = self.model.set_elite(new_state, order[:k])
        self._train_iteration += 1
        return new_state, training_losses, val_scores

    def _pad_epoch(self, stacked: TransitionBatch) -> TransitionBatch:
        m = self.pad_epoch_to_multiple
        if not m:
            return stacked
        n = len(stacked)
        bucket = ((n + m - 1) // m) * m
        if bucket == n:
            return stacked
        return stacked[np.arange(bucket) % n]

    def _stack_eval(self, dataset) -> TransitionBatch:
        """Whole validation set as one device batch (bootstrap OFF).

        For sequence iterators the underlying ``transitions`` attribute holds the
        valid-start index array, so the windows are materialized by iterating."""
        from mbrl_tpu_torch.util.replay_buffer import (
            BootstrapIterator,
            SequenceTransitionIterator,
            SequenceTransitionSampler,
            TransitionIterator,
        )

        dev = self.model.device
        if not isinstance(dataset, TransitionIterator):
            return dataset.to(dev)
        toggled = False
        if isinstance(dataset, BootstrapIterator) and dataset._bootstrap_iter:
            dataset.toggle_bootstrap()
            toggled = True
        try:
            if isinstance(dataset, (SequenceTransitionIterator, SequenceTransitionSampler)):
                batches = list(dataset)
                all_data = TransitionBatch(
                    *(np.concatenate(xs, axis=0) for xs in zip(*(b.astuple() for b in batches)))
                )
            else:
                all_data = dataset.transitions
            batch = all_data.to(dev)
        finally:
            if toggled:
                dataset.toggle_bootstrap()
        return batch

    def evaluate(self, state: Dict[str, Any], dataset) -> np.ndarray:
        """Per-member validation score over a dataset (host API)."""
        batch = self._stack_eval(dataset)
        return self._scores(
            {"params": state["params"], "normalizer": state.get("normalizer")}, batch
        ).cpu().numpy()

    # ------------------------------------------------------------------ #
    # Device-resident training
    # ------------------------------------------------------------------ #
    # The host path above re-stacks and re-uploads the whole dataset every
    # epoch. This path keeps the dataset on the device
    # (util.device_buffer.DeviceTransitionDataset) and draws there: a shuffled
    # train/val split over the valid rows, one bootstrap multiset per member
    # per call, a fresh per-member order of it every epoch. Per-member early
    # stopping, best-weights tracking and elite selection follow the host path
    # epoch for epoch.
    #
    # The JAX package sizes this program by a geometric bucketing of the row
    # count so that XLA recompiles O(log n) times. Eager PyTorch compiles
    # nothing, but the bucketing also fixes `num_batches` and `val_rows`, that
    # is how many gradient steps an epoch has, so that arithmetic is kept. What
    # served recompilation alone is dropped: the capacity-sized masked sort
    # (only the valid rows are permuted here) and the fixed-length loss arrays.

    def train_device(
        self,
        state: Dict[str, Any],
        dataset,  # util.device_buffer.DeviceTransitionDataset
        *,
        batch_size: int,
        val_ratio: float,
        num_epochs: Optional[int] = None,
        patience: Optional[int] = None,
        improvement_threshold: float = 0.01,
        max_epochs: int = 512,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, Any], List[float], List[float]]:
        """Device-resident counterpart of :meth:`train`: no per-epoch upload, one
        small device-to-host read per epoch (its losses and scores)."""
        if generator is None:
            generator = torch.Generator().manual_seed(self._train_iteration)
        E = max(len(self.model), 1)
        n = min(int(dataset.num_stored), dataset.capacity)
        dev = dataset.device
        val_rows, num_batches = _device_sizes(n, dataset.capacity, batch_size, val_ratio)
        if num_epochs is not None:
            max_epochs = num_epochs
        if patience is None:
            patience = max_epochs  # never triggers
        elite_k = getattr(self.model, "num_elites", None) or E

        # float32 arithmetic, as the reference computes the split size
        n_val = int(np.float32(n) * np.float32(val_ratio))
        n_train = max(n - n_val, 1)
        perm = randperm(generator, n, dev)  # shuffled split over the valid rows
        # bootstrap multiset: sampled once per call, WITH replacement, per member
        boot_pos = randint(generator, 0, n_train, (E, num_batches * batch_size), dev)
        train_idx = perm[boot_pos]  # (E, nb*B) rows into data
        # validation rows: the split's tail, cycled up to `val_rows` (duplicates
        # only weight the mean). When the split leaves no validation rows
        # (val_ratio=0 or a tiny dataset), score on training rows instead.
        arange_v = torch.arange(val_rows, device=dev)
        val_pos = n_train + arange_v % max(n_val, 1) if n_val > 0 else arange_v % n_train
        data = dataset.data
        val_batch = data[perm[val_pos]]

        work = _Work(self, state)
        best_val = self._work_scores(work, val_batch)
        best_leaves = None
        losses: List[float] = []
        vals: List[np.ndarray] = []
        epochs_since_update = 0
        for epoch in range(max_epochs):
            if epochs_since_update >= patience:
                break
            # fresh per-member ORDER of the same bootstrap multiset each epoch
            order = torch.argsort(rand(generator, (E, num_batches * batch_size), dev), dim=1)
            idx = torch.gather(train_idx, 1, order)
            idx = idx.reshape(E, num_batches, batch_size).permute(1, 0, 2)
            batch_losses = []
            for b in range(num_batches):
                loss, _, rows_split = self._loss(work, data[idx[b]], generator)  # (E, B, ...)
                work.step(loss, rows_split=rows_split)
                batch_losses.append(loss.detach())
            batch_losses = torch.stack(batch_losses)
            if work.plan is not None:
                batch_losses = work.plan.reduce_losses(batch_losses, rows_split)
            scores = self._work_scores(work, val_batch)  # (E,)
            improved = ((best_val - scores) / best_val.abs().clamp_min(1e-12)) > improvement_threshold
            # the epoch's one read-back: mean loss, scores, any-member improvement
            host = torch.cat(
                [batch_losses.mean()[None], scores, improved.any()[None].float()]
            ).cpu().numpy()
            _require_finite("train loss", host[0], "train_device")
            _require_finite("validation score", host[1:-1], "train_device")
            losses.append(float(host[0]))
            vals.append(host[1:-1].copy())
            if host[-1]:
                best_val = torch.minimum(best_val, scores)
                best_leaves = work.snapshot()
                epochs_since_update = 0
            else:
                epochs_since_update += 1

        best_params = state["params"] if best_leaves is None else work.params_with(best_leaves)
        new_state = {**state, "params": best_params, "opt_state": work.opt_state()}
        final_scores = self._scores({"params": best_params, "normalizer": work.normalizer}, val_batch)
        if E > 1 and hasattr(self.model, "set_elite"):
            new_state = self.model.set_elite(new_state, torch.argsort(final_scores)[:elite_k])

        best_mean = np.minimum.accumulate([v.mean() for v in vals]) if vals else []
        if self.logger is not None:
            for e in range(len(losses)):
                self.logger.log_data(
                    self._LOG_GROUP_NAME,
                    {
                        "train_iteration": self._train_iteration,
                        "epoch": e,
                        "train_dataset_size": num_batches * batch_size,
                        "val_dataset_size": val_rows,
                        "model_loss": losses[e],
                        "model_val_score": float(vals[e].mean()),
                        "model_best_val_score": float(best_mean[e]),
                    },
                )
        self._train_iteration += 1
        return new_state, losses, [float(v.mean()) for v in vals]

    # ------------------------------------------------------------------ #
    # Device-resident SEQUENCE training (PlaNet)
    # ------------------------------------------------------------------ #
    # Windows of `seq_len` rows are gathered on the device from a uint8 pixel
    # dataset each step, so only the dataset (1 byte a texel) and one batch's
    # float pixels are live; the host route stacks every batch of the call.

    def train_device_sequences(
        self,
        state: Dict[str, Any],
        dataset,  # util.device_buffer.DeviceTransitionDataset
        valid_starts: np.ndarray,
        *,
        num_updates: int,
        batch_size: int,
        seq_len: int,
        generator: Optional[torch.Generator] = None,
        batch_callback: Optional[Callable] = None,
    ) -> Tuple[Dict[str, Any], List[float]]:
        """``num_updates`` gradient steps, each on ``batch_size`` windows whose
        starts are drawn uniformly from ``valid_starts`` (row ids of the
        dataset); one read-back at the end. ``batch_callback(0, loss, meta,
        "train")`` gets each step's loss meta with its pre-clip ``grad_norm``.
        Returns the new state (params and optimizer state) and the losses."""
        if generator is None:
            generator = torch.Generator().manual_seed(self._train_iteration)
        n_starts = int(len(valid_starts))
        if n_starts == 0:
            raise ValueError(f"no trajectory holds a window of {seq_len} rows")
        dev = dataset.device
        starts = torch.as_tensor(np.asarray(valid_starts), dtype=torch.int64, device=dev)
        offsets = torch.arange(seq_len, device=dev)
        work = _Work(self, state)
        losses, metas = [], []
        with self._precision():
            for _ in range(num_updates):
                pos = randint(generator, 0, n_starts, (batch_size,), dev)
                batch = dataset.data[starts[pos][:, None] + offsets[None, :]]  # (B, L, ...)
                loss, meta, rows_split = self._loss(work, batch, generator, member_stacked=False)
                norm = work.step(loss, want_norm=True, rows_split=rows_split)
                losses.append(loss.detach())
                metas.append({**_detached(meta), "grad_norm": norm})
        host_losses = torch.stack(losses)
        if work.plan is not None and num_updates:
            host_losses = work.plan.reduce_losses(host_losses, rows_split)
            metas = work.plan.reduce_metas(metas, rows_split)
        host_losses = host_losses.cpu().numpy()
        _require_finite("train loss", host_losses, "train_device_sequences")
        if batch_callback is not None:
            for i, meta in enumerate(_host_metas(metas)):
                batch_callback(0, float(host_losses[i]), meta, "train")
        if self.logger is not None:
            self.logger.log_data(
                self._LOG_GROUP_NAME,
                {
                    "train_iteration": self._train_iteration,
                    "epoch": 0,
                    "train_dataset_size": n_starts,
                    "val_dataset_size": 0,
                    "model_loss": float(host_losses.mean()),
                    "model_val_score": float(host_losses[-1]),
                    "model_best_val_score": float(host_losses.min()),
                },
            )
        self._train_iteration += 1
        new_state = {**state, "params": work.params_with(work.leaves),
                     "opt_state": work.opt_state()}
        return new_state, [float(v) for v in host_losses]


def _detached(meta: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v.detach() for k, v in meta.items()}


def _host_metas(metas: List[Dict[str, Any]]) -> List[Dict[str, float]]:
    """Per-step meta dicts of 0-d tensors as floats, in one device read."""
    if not metas:
        return []
    keys = list(metas[0])
    host = torch.stack([torch.stack([m[k].float() for k in keys]) for m in metas])
    return [dict(zip(keys, map(float, row))) for row in host.cpu().numpy()]


def _bucket_rows(n: int, floor: int = 256, growth: float = 1.25) -> int:
    """Geometric 256-multiple bucketing of a row count (shared with
    DeviceTransitionDataset's capacity growth)."""
    cap = floor
    while cap < n:
        cap = int(-(-cap * growth // 256) * 256)
    return cap


def _device_sizes(n_live: int, capacity: int, batch_size: int, val_ratio: float) -> Tuple[int, int]:
    """``(val_rows, num_batches)`` of a ``train_device`` call: sized by the
    bucketed count of LIVE rows (not the allocated capacity, which can
    overshoot by the dataset's growth factor), so an epoch has as many gradient
    steps as the JAX package's."""
    rows_bucket = min(_bucket_rows(n_live), capacity)
    val_rows = max(int(np.ceil(rows_bucket * val_ratio)), 1)
    num_batches = max((rows_bucket - val_rows) // batch_size, 1)
    return val_rows, num_batches


def _dataset_size(dataset) -> int:
    try:
        return int(dataset.num_stored)
    except AttributeError:
        try:
            return len(dataset)
        except TypeError:
            return 0
