"""Replay buffer and data iterators (counterpart of
``mbrl_tpu/util/replay_buffer.py``).

All of it is host-side numpy: the ring buffer absorbs single environment
transitions, and every iterator can be materialized as one stacked epoch
(:func:`stack_iterator`) that the trainer moves to the device once per epoch.
Bootstrap member indices are drawn for all members in one call. Trajectory
bookkeeping (sequence sampling) keeps trajectories contiguous: the capacity is
padded by ``max_trajectory_length`` and overlapping old trajectories are
evicted on wrap. ``replay_buffer.npz`` has the JAX package's keys, so a buffer
saved by either package loads in the other.
"""
from __future__ import annotations

import pathlib
import warnings
from typing import Any, List, Optional, Sequence, Tuple, Type, Union

import numpy as np

from mbrl_tpu_torch.types import TransitionBatch

_BUFFER_FNAME = "replay_buffer.npz"


def _valid_sequence_starts(
    trajectory_indices: Sequence[Tuple[int, int]], sequence_length: int
) -> np.ndarray:
    """All buffer positions from which a full `sequence_length` window fits inside
    one trajectory."""
    starts: List[int] = []
    for lo, hi in trajectory_indices:
        if hi - lo >= sequence_length:
            starts.extend(range(lo, hi - sequence_length + 1))
    return np.asarray(starts, dtype=np.int64)


class ReplayBuffer:
    """FIFO transition store with uniform sampling and optional trajectory tracking.

    When ``max_trajectory_length`` is given, the physical storage is padded by that
    amount so an in-progress trajectory never wraps mid-sequence, and a list of
    ``[start, end)`` segments is maintained (old segments evicted as they are
    overwritten).
    """

    def __init__(
        self,
        capacity: int,
        obs_shape: Sequence[int],
        action_shape: Sequence[int],
        obs_type: Type = np.float32,
        action_type: Type = np.float32,
        reward_type: Type = np.float32,
        rng: Optional[np.random.Generator] = None,
        max_trajectory_length: Optional[int] = None,
    ):
        self.capacity = capacity
        self.cur_idx = 0
        self.num_stored = 0
        # monotone lifetime write counter (never wraps): lets device mirrors
        # detect how many rows landed since their last sync
        self.total_added = 0
        self._rng = rng if rng is not None else np.random.default_rng()

        self.trajectory_indices: Optional[List[Tuple[int, int]]] = None
        self._start_last_trajectory = 0
        storage_size = capacity
        if max_trajectory_length:
            self.trajectory_indices = []
            storage_size += max_trajectory_length

        self.obs = np.empty((storage_size, *obs_shape), dtype=obs_type)
        self.next_obs = np.empty((storage_size, *obs_shape), dtype=obs_type)
        self.action = np.empty((storage_size, *action_shape), dtype=action_type)
        self.reward = np.empty(storage_size, dtype=reward_type)
        self.terminated = np.empty(storage_size, dtype=bool)
        self.truncated = np.empty(storage_size, dtype=bool)

    # ------------------------------------------------------------------ #
    # Writing
    # ------------------------------------------------------------------ #
    def add(self, obs, action, next_obs, reward, terminated, truncated) -> None:
        """Store one transition; advances the ring (with trajectory bookkeeping)."""
        self.total_added += 1
        i = self.cur_idx
        self.obs[i] = obs
        self.action[i] = action
        self.next_obs[i] = next_obs
        self.reward[i] = reward
        self.terminated[i] = terminated
        self.truncated[i] = truncated

        if self.trajectory_indices is None:
            self.cur_idx = (i + 1) % self.capacity
            self.num_stored = min(self.num_stored + 1, self.capacity)
            return

        # Trajectory mode: advance into the padded region if needed; only reset to 0
        # at trajectory close (so sequences stay contiguous).
        self.cur_idx += 1
        if self.num_stored < self.capacity:
            self.num_stored += 1
        if self.cur_idx >= self.capacity:
            self.num_stored = max(self.num_stored, self.cur_idx)
        if terminated or truncated:
            self.close_trajectory()
        else:
            self._evict_overlapping((self._start_last_trajectory, self.cur_idx + 1))

        if self.cur_idx >= len(self.obs):
            warnings.warn(
                "Replay buffer (including trajectory padding) filled before the "
                "current trajectory finished; its partial history is discarded. "
                "Increase max_trajectory_length."
            )
            self._start_last_trajectory = 0
            self.cur_idx = 0
            self.num_stored = len(self.obs)

    def close_trajectory(self) -> None:
        """Finish the in-progress trajectory, evicting overwritten old segments."""
        segment = (self._start_last_trajectory, self.cur_idx)
        self._evict_overlapping(segment)
        self.trajectory_indices.append(segment)

        if segment[1] - segment[0] > len(self.obs) - self.capacity:
            warnings.warn(
                "A trajectory exceeded max_trajectory_length; unexpected behavior "
                "might occur."
            )
        if self.cur_idx >= self.capacity:
            self.cur_idx = 0
        self._start_last_trajectory = self.cur_idx

    def _evict_overlapping(self, segment: Tuple[int, int]) -> None:
        s2, e2 = segment

        def overlaps(traj: Tuple[int, int]) -> bool:
            s1, e1 = traj
            return (s1 <= s2 < e1) or (s1 < e2 <= e1)

        while self.trajectory_indices and overlaps(self.trajectory_indices[0]):
            self.trajectory_indices.pop(0)

    def add_batch(self, obs, action, next_obs, reward, terminated, truncated) -> None:
        """Bulk store a batch of transitions with ring wraparound (no trajectory
        tracking: trajectories are tracked via add() only)."""
        n = len(obs)
        self.total_added += n
        start = self.cur_idx
        first = min(n, self.capacity - start)

        def write(dst_lo: int, src_lo: int, count: int) -> None:
            sl_dst = slice(dst_lo, dst_lo + count)
            sl_src = slice(src_lo, src_lo + count)
            self.obs[sl_dst] = obs[sl_src]
            self.action[sl_dst] = action[sl_src]
            self.next_obs[sl_dst] = next_obs[sl_src]
            self.reward[sl_dst] = reward[sl_src]
            self.terminated[sl_dst] = terminated[sl_src]
            self.truncated[sl_dst] = truncated[sl_src]

        write(start, 0, first)
        if first < n:
            # wrapped: remainder goes to the front, buffer is now full
            write(0, first, n - first)
            self.num_stored = self.capacity
        self.cur_idx = (start + n) % self.capacity
        self.num_stored = min(self.num_stored + n, self.capacity)

    # ------------------------------------------------------------------ #
    # Reading
    # ------------------------------------------------------------------ #
    def _gather(self, indices) -> TransitionBatch:
        return TransitionBatch(
            self.obs[indices],
            self.action[indices],
            self.next_obs[indices],
            self.reward[indices],
            self.terminated[indices],
            self.truncated[indices],
        )

    def sample(self, batch_size: int) -> TransitionBatch:
        """Uniform sample with replacement."""
        indices = self._rng.choice(self.num_stored, size=batch_size)
        return self._gather(indices)

    def sample_trajectory(self) -> Optional[TransitionBatch]:
        """Sample one full stored trajectory (or None if not tracking/empty)."""
        if not self.trajectory_indices:
            return None
        lo, hi = self.trajectory_indices[self._rng.choice(len(self.trajectory_indices))]
        return self._gather(np.arange(lo, hi))

    def get_all(self, shuffle: bool = False) -> TransitionBatch:
        """All stored transitions, optionally in random order."""
        if shuffle:
            return self._gather(self._rng.permutation(self.num_stored))
        return self._gather(slice(0, self.num_stored))

    def get_range(self, start: int, end: int) -> TransitionBatch:
        """Physical rows [start, end) — incremental device-mirror syncs."""
        return self._gather(slice(start, end))

    def __len__(self) -> int:
        return self.num_stored

    @property
    def stores_trajectories(self) -> bool:
        return self.trajectory_indices is not None

    @property
    def rng(self) -> np.random.Generator:
        return self._rng

    # ------------------------------------------------------------------ #
    # Persistence
    # ------------------------------------------------------------------ #
    def save(self, save_dir: Union[pathlib.Path, str]) -> None:
        path = pathlib.Path(save_dir) / _BUFFER_FNAME
        np.savez(
            path,
            obs=self.obs[: self.num_stored],
            next_obs=self.next_obs[: self.num_stored],
            action=self.action[: self.num_stored],
            reward=self.reward[: self.num_stored],
            terminated=self.terminated[: self.num_stored],
            truncated=self.truncated[: self.num_stored],
            trajectory_indices=np.asarray(self.trajectory_indices or [], dtype=np.int64),
        )

    def load(self, load_dir: Union[pathlib.Path, str]) -> None:
        data = np.load(pathlib.Path(load_dir) / _BUFFER_FNAME)
        n = len(data["obs"])
        self.obs[:n] = data["obs"]
        self.next_obs[:n] = data["next_obs"]
        self.action[:n] = data["action"]
        self.reward[:n] = data["reward"]
        self.terminated[:n] = data["terminated"]
        self.truncated[:n] = data["truncated"]
        self.num_stored = n
        self.cur_idx = n % self.capacity
        self.total_added = n
        if "trajectory_indices" in data and len(data["trajectory_indices"]):
            self.trajectory_indices = [tuple(t) for t in data["trajectory_indices"]]


# ---------------------------------------------------------------------- #
# Iterators
# ---------------------------------------------------------------------- #
class TransitionIterator:
    """Epoch iterator over a TransitionBatch with optional per-epoch shuffling."""

    def __init__(
        self,
        transitions: TransitionBatch,
        batch_size: int,
        shuffle_each_epoch: bool = False,
        rng: Optional[np.random.Generator] = None,
    ):
        self.transitions = transitions
        self.num_stored = len(transitions)
        self.batch_size = batch_size
        self._shuffle_each_epoch = shuffle_each_epoch
        self._rng = rng if rng is not None else np.random.default_rng()
        self._order = np.arange(self.num_stored)
        self._current_batch = 0

    def _next_batch_indices(self) -> np.ndarray:
        lo = self._current_batch * self.batch_size
        if lo >= self.num_stored:
            raise StopIteration
        hi = min(lo + self.batch_size, self.num_stored)
        self._current_batch += 1
        return self._order[lo:hi]

    def __iter__(self):
        self._current_batch = 0
        if self._shuffle_each_epoch:
            self._order = self._rng.permutation(self.num_stored)
        return self

    def __next__(self) -> TransitionBatch:
        return self[self._next_batch_indices()]

    def __getitem__(self, item) -> TransitionBatch:
        return self.transitions[item]

    def __len__(self) -> int:
        return (self.num_stored - 1) // self.batch_size + 1

    @property
    def ensemble_size(self) -> int:
        return 0


class BootstrapIterator(TransitionIterator):
    """Iterator yielding per-ensemble-member bootstrapped ``E x B x ...`` batches.

    Each member gets its own permutation (or with-replacement resample) of the data.
    ``toggle_bootstrap`` switches to plain batches for validation."""

    def __init__(
        self,
        transitions: TransitionBatch,
        batch_size: int,
        ensemble_size: int,
        shuffle_each_epoch: bool = False,
        permute_indices: bool = True,
        rng: Optional[np.random.Generator] = None,
    ):
        super().__init__(transitions, batch_size, shuffle_each_epoch, rng)
        self._ensemble_size = ensemble_size
        self._permute_indices = permute_indices
        self._bootstrap_iter = ensemble_size > 1
        self.member_indices = self._sample_member_indices()

    def _sample_member_indices(self) -> np.ndarray:
        if self._permute_indices:
            return self._rng.permuted(
                np.broadcast_to(
                    np.arange(self.num_stored), (self._ensemble_size, self.num_stored)
                ),
                axis=1,
            )
        return self._rng.choice(
            self.num_stored, size=(self._ensemble_size, self.num_stored), replace=True
        )

    def __iter__(self):
        super().__iter__()
        return self

    def __next__(self) -> TransitionBatch:
        if not self._bootstrap_iter:
            return super().__next__()
        indices = self._next_batch_indices()
        # (E, b) gather in one shot, then reshape member batches onto a leading axis
        content = self.member_indices[:, indices]
        return self._gather_members(content)

    def _gather_members(self, content: np.ndarray) -> TransitionBatch:
        e, b = content.shape
        flat = self.transitions[content.reshape(-1)]
        return flat.map(lambda x: np.asarray(x).reshape((e, b) + np.shape(x)[1:]))

    def toggle_bootstrap(self) -> None:
        if self._ensemble_size > 1:
            self._bootstrap_iter = not self._bootstrap_iter

    @property
    def ensemble_size(self) -> int:
        return self._ensemble_size


class SequenceTransitionIterator(BootstrapIterator):
    """Bootstrapped iterator over fixed-length trajectory windows (``E x B x L x ...``).

    Valid start positions are every index from which a full window fits inside one
    stored trajectory; member datasets are resampled with replacement."""

    def __init__(
        self,
        transitions: TransitionBatch,
        trajectory_indices: Sequence[Tuple[int, int]],
        batch_size: int,
        sequence_length: int,
        ensemble_size: int,
        shuffle_each_epoch: bool = False,
        rng: Optional[np.random.Generator] = None,
        max_batches_per_loop: Optional[int] = None,
    ):
        self._sequence_length = sequence_length
        self._max_batches_per_loop = max_batches_per_loop
        self._valid_starts = _valid_sequence_starts(trajectory_indices, sequence_length)
        if len(self._valid_starts) < 0.5 * len(trajectory_indices):
            warnings.warn(
                "More than 50% of the trajectories were discarded for being shorter "
                "than the specified length."
            )
        self._full_transitions = transitions
        # The superclass machinery indexes into the set of valid starts; __getitem__
        # then expands each start into a window.
        super().__init__(
            self._valid_starts,  # type: ignore[arg-type]
            batch_size,
            ensemble_size,
            shuffle_each_epoch=shuffle_each_epoch,
            permute_indices=False,
            rng=rng,
        )

    def __next__(self) -> TransitionBatch:
        if (
            self._max_batches_per_loop is not None
            and self._current_batch >= self._max_batches_per_loop
        ):
            raise StopIteration
        return super().__next__()

    def __len__(self) -> int:
        n = super().__len__()
        if self._max_batches_per_loop is not None:
            return min(n, self._max_batches_per_loop)
        return n

    def __getitem__(self, item) -> TransitionBatch:
        return _windows(
            self._full_transitions, self._valid_starts, item, self._sequence_length
        )

    def _gather_members(self, content: np.ndarray) -> TransitionBatch:
        e, b = content.shape
        flat = self[content.reshape(-1)]  # (e*b, L, ...)
        return flat.map(lambda x: np.asarray(x).reshape((e, b) + np.shape(x)[1:]))


class SequenceTransitionSampler(TransitionIterator):
    """Random-with-replacement sequence sampler with a fixed number of batches per
    loop (PlaNet's training data source)."""

    def __init__(
        self,
        transitions: TransitionBatch,
        trajectory_indices: Sequence[Tuple[int, int]],
        batch_size: int,
        sequence_length: int,
        batches_per_loop: int,
        rng: Optional[np.random.Generator] = None,
    ):
        self._sequence_length = sequence_length
        self._batches_per_loop = batches_per_loop
        self._valid_starts = _valid_sequence_starts(trajectory_indices, sequence_length)
        if len(self._valid_starts) < 0.5 * len(trajectory_indices):
            warnings.warn(
                "More than 50% of the trajectories were discarded for being shorter "
                "than the specified length."
            )
        self._full_transitions = transitions
        super().__init__(
            self._valid_starts, batch_size, shuffle_each_epoch=True, rng=rng  # type: ignore[arg-type]
        )

    def __iter__(self):
        self._current_batch = 0
        return self

    def __next__(self) -> TransitionBatch:
        if self._current_batch >= self._batches_per_loop:
            raise StopIteration
        self._current_batch += 1
        indices = self._rng.choice(self.num_stored, size=self.batch_size, replace=True)
        return self[indices]

    def __len__(self) -> int:
        return self._batches_per_loop

    def __getitem__(self, item) -> TransitionBatch:
        return _windows(
            self._full_transitions, self._valid_starts, item, self._sequence_length
        )


def _windows(
    transitions: TransitionBatch,
    valid_starts: np.ndarray,
    item: Any,
    sequence_length: int,
) -> TransitionBatch:
    """Expand selected start indices into (B, L, ...) contiguous windows."""
    starts = np.atleast_1d(valid_starts[item])
    idx = starts[:, None] + np.arange(sequence_length)[None, :]  # (B, L)
    return transitions.map(lambda x: np.asarray(x)[idx])


def stack_iterator(iterator: TransitionIterator, drop_last: bool = True):
    """Materialize one full epoch of an iterator as a single stacked batch.

    Returns a TransitionBatch whose leaves have a leading ``num_batches`` axis:
    moved to the device once, then consumed batch by batch along axis 0.

    ``drop_last`` drops a trailing ragged batch so all slices have equal shape.
    """
    batches = list(iterator)
    if drop_last and len(batches) > 1:
        if len(batches[-1]) != len(batches[0]) or batches[-1].obs.shape != batches[0].obs.shape:
            batches = batches[:-1]
    return TransitionBatch(
        *(np.stack(xs, axis=0) for xs in zip(*(b.astuple() for b in batches)))
    )
