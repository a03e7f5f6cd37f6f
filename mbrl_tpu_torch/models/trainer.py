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


class _Work:
    """One call's trainable copy of the params, its optimizer and the paths of
    the trainable leaves."""

    def __init__(self, trainer: "ModelTrainer", state: Dict[str, Any]):
        params = state["params"]
        frozen = set(getattr(trainer.model, "frozen_param_keys", ()))
        self.paths = [
            path for path, leaf in tree_leaves_with_path(params)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and path[0] not in frozen
        ]
        self.leaves = []
        self.params = params
        for path in self.paths:
            leaf = params
            for key in path:
                leaf = leaf[key]
            leaf = leaf.detach().clone().requires_grad_(True)
            self.leaves.append(leaf)
            self.params = tree_set(self.params, path, leaf)
        # one parameter group: the decay reaches every trainable leaf, biases too
        self.optimizer = torch.optim.Adam(
            self.leaves, lr=trainer.optim_lr, weight_decay=trainer.weight_decay,
            eps=trainer.optim_eps,
        )
        opt_state = state.get("opt_state")
        if opt_state is not None:
            opt_state = copy.deepcopy(opt_state)
            for entry in opt_state["state"].values():
                if isinstance(entry.get("step"), torch.Tensor):
                    entry["step"] = entry["step"].cpu()  # read on the host every step
            self.optimizer.load_state_dict(opt_state)
        self.normalizer = state.get("normalizer")
        self.clip_norm = getattr(trainer.model, "grad_clip_norm", None)

    def state(self) -> Dict[str, Any]:
        return {"params": self.params, "normalizer": self.normalizer}

    def snapshot(self) -> List[torch.Tensor]:
        return [leaf.detach().clone() for leaf in self.leaves]

    def params_with(self, leaves: List[torch.Tensor]):
        params = self.params
        for path, leaf in zip(self.paths, leaves):
            params = tree_set(params, path, leaf.detach())
        return params

    def opt_state(self):
        return copy.deepcopy(self.optimizer.state_dict())

    def step(self, loss: torch.Tensor, want_norm: bool = False) -> Optional[torch.Tensor]:
        """One optimizer update from ``loss``; the pre-clip global gradient
        norm when clipping or ``want_norm``."""
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        norm = None
        if self.clip_norm:
            norm = torch.nn.utils.clip_grad_norm_(self.leaves, self.clip_norm)
        elif want_norm:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(l.grad) for l in self.leaves])
            )
        self.optimizer.step()
        return norm


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
        if parallel_ctx is not None:
            raise NotImplementedError(
                "parallel_ctx (mesh sharding) comes with the slice that ports parallel/; pass None"
            )
        self.model = model
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

    def _loss(self, work: _Work, batch: TransitionBatch, generator: torch.Generator):
        if self._stochastic_loss:
            return self.model.loss(work.state(), batch, generator=generator)
        return self.model.loss(work.state(), batch)

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
            self._scores(work.state(), val_batch).cpu().numpy() if evaluate else None
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
                with self._precision():
                    loss, meta = self._loss(work, stacked[i], generator)
                    norm = work.step(loss, want_norm=batch_callback is not None)
                losses.append(loss.detach())
                metas.append({**_detached(meta), "grad_norm": norm})
            batch_losses = torch.stack(losses).cpu().numpy()  # the epoch's one read-back
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

            member_scores = self._scores(work.state(), val_batch).cpu().numpy()
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
        best_val = self._scores(work.state(), val_batch)
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
                loss, _ = self.model.loss(work.state(), data[idx[b]])  # (E, B, ...)
                work.step(loss)
                batch_losses.append(loss.detach())
            scores = self._scores(work.state(), val_batch)  # (E,)
            improved = ((best_val - scores) / best_val.abs().clamp_min(1e-12)) > improvement_threshold
            # the epoch's one read-back: mean loss, scores, any-member improvement
            host = torch.cat(
                [torch.stack(batch_losses).mean()[None], scores, improved.any()[None].float()]
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
                loss, meta = self._loss(work, batch, generator)
                norm = work.step(loss, want_norm=True)
                losses.append(loss.detach())
                metas.append({**_detached(meta), "grad_norm": norm})
        host_losses = torch.stack(losses).cpu().numpy()
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
