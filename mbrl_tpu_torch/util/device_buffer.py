"""Device-resident buffers (counterpart of ``mbrl_tpu/util/device_buffer.py``).

``DeviceReplayBuffer`` is MBPO's SAC buffer: a ring of (obs, act, next_obs,
reward, mask) in device memory that imagined rollouts write and SAC updates
sample, with no host round trip. ``DeviceTransitionDataset`` mirrors a host
``ReplayBuffer`` in device memory for ``ModelTrainer.train_device``: each sync
moves only the rows written since the last one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from mbrl_tpu_torch.device import DeviceLike, resolve_device
from mbrl_tpu_torch.types import TransitionBatch

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def uniform_indices(
    generator: torch.Generator, shape, num_stored: torch.Tensor
) -> torch.Tensor:
    """int64 indices uniform in ``[0, max(num_stored, 1))``, drawn on
    ``num_stored``'s device from ``generator`` (on the same device), without
    reading ``num_stored`` back to the host."""
    n = torch.clamp(num_stored, min=1).to(torch.float64)
    u = torch.rand(tuple(shape), generator=generator, device=num_stored.device,
                   dtype=torch.float64)
    return torch.minimum((u * n).long(), n.long() - 1)


@dataclasses.dataclass
class DeviceBufferState:
    """The ring's tensors: ``capacity + 1`` rows (the last is the scratch row
    that masked-out writes land in) and two 0-d int64 counters."""

    obs: torch.Tensor
    act: torch.Tensor
    next_obs: torch.Tensor
    reward: torch.Tensor  # (capacity + 1, 1)
    mask: torch.Tensor  # (capacity + 1, 1): 1 - terminated (SAC convention)
    cur_idx: torch.Tensor
    num_stored: torch.Tensor

    def arrays(self) -> Batch:
        return self.obs, self.act, self.next_obs, self.reward, self.mask


class DeviceReplayBuffer:
    """Fixed-capacity device ring buffer of (obs, act, next_obs, reward, mask).

    As the JAX package's, the buffer object holds the sizes and a
    :class:`DeviceBufferState` holds the data; unlike it, the writes go into
    the state's tensors in place (no second copy of the ring), and each method
    returns the state it was given. The counters stay on the device, so
    nothing here waits for the device except :meth:`resize`.
    """

    def __init__(self, capacity: int, obs_dim: int, act_dim: int, device: DeviceLike = "cuda"):
        self.capacity = int(capacity)
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.device = resolve_device(device)

    def init(self) -> DeviceBufferState:
        c, dev = self.capacity + 1, self.device
        return DeviceBufferState(
            obs=torch.zeros((c, self.obs_dim), device=dev),
            act=torch.zeros((c, self.act_dim), device=dev),
            next_obs=torch.zeros((c, self.obs_dim), device=dev),
            reward=torch.zeros((c, 1), device=dev),
            mask=torch.ones((c, 1), device=dev),
            cur_idx=torch.zeros((), dtype=torch.int64, device=dev),
            num_stored=torch.zeros((), dtype=torch.int64, device=dev),
        )

    def _rows(self, obs, act, next_obs, reward, mask) -> Batch:
        def f32(x, shape):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device).reshape(shape)

        return (f32(obs, (-1, self.obs_dim)), f32(act, (-1, self.act_dim)),
                f32(next_obs, (-1, self.obs_dim)), f32(reward, (-1, 1)), f32(mask, (-1, 1)))

    def _write(self, state: DeviceBufferState, positions: torch.Tensor, rows: Batch) -> None:
        for dst, src in zip(state.arrays(), rows):
            dst.index_put_((positions,), src)

    def add_batch(
        self, state: DeviceBufferState, obs, act, next_obs, reward, mask
    ) -> DeviceBufferState:
        """Ring-write a batch at ``cur_idx``. Of a batch longer than the ring
        only its last ``capacity`` rows land (what the JAX package's scatter
        leaves)."""
        rows = self._rows(obs, act, next_obs, reward, mask)
        n = rows[0].shape[0]
        skip = max(n - self.capacity, 0)
        k = n - skip
        positions = (state.cur_idx + skip
                     + torch.arange(k, dtype=torch.int64, device=self.device)) % self.capacity
        self._write(state, positions, tuple(r[skip:] for r in rows))
        state.cur_idx.copy_((state.cur_idx + n) % self.capacity)
        state.num_stored.copy_(torch.clamp(state.num_stored + n, max=self.capacity))
        return state

    def add_batch_masked(
        self, state: DeviceBufferState, obs, act, next_obs, reward, mask, valid
    ) -> DeviceBufferState:
        """Ring-write only the rows with ``valid`` true, packed into
        consecutive slots by a cumulative sum; the others go to the scratch
        row at index ``capacity``. No host sync (used inside MBPO's imagined
        rollout, where particles die as they terminate)."""
        rows = self._rows(obs, act, next_obs, reward, mask)
        valid = torch.as_tensor(valid, device=self.device).reshape(-1).to(torch.int64)
        offsets = torch.cumsum(valid, 0) - 1
        n_valid = valid.sum()
        positions = torch.where(valid.bool(), (state.cur_idx + offsets) % self.capacity,
                                torch.full_like(offsets, self.capacity))
        self._write(state, positions, rows)
        state.cur_idx.copy_((state.cur_idx + n_valid) % self.capacity)
        state.num_stored.copy_(torch.clamp(state.num_stored + n_valid, max=self.capacity))
        return state

    @staticmethod
    def gather(state: DeviceBufferState, idx: torch.Tensor) -> Batch:
        return tuple(a[idx] for a in state.arrays())

    def sample(self, state: DeviceBufferState, generator: torch.Generator, batch_size: int) -> Batch:
        """A uniform batch (obs, act, next_obs, reward, mask) of the stored rows."""
        return self.gather(state, uniform_indices(generator, (batch_size,), state.num_stored))

    def sample_many(
        self, state: DeviceBufferState, generator: torch.Generator, num_batches: int,
        batch_size: int,
    ) -> Batch:
        """Stacked batches (N, B, ...) for a bundle of updates."""
        idx = uniform_indices(generator, (num_batches, batch_size), state.num_stored)
        return self.gather(state, idx)

    def resize(
        self, state: DeviceBufferState, new_capacity: int
    ) -> "Tuple[DeviceReplayBuffer, DeviceBufferState]":
        """A buffer of ``new_capacity`` holding the newest transitions in
        order (MBPO's ``maybe_replace_sac_buffer``). Reads the counters."""
        new_buf = DeviceReplayBuffer(new_capacity, self.obs_dim, self.act_dim, self.device)
        new_state = new_buf.init()
        n = int(state.num_stored)
        if n == 0:
            return new_buf, new_state
        keep = min(n, new_capacity)
        end = int(state.cur_idx)
        if n == self.capacity:
            idx = (torch.arange(keep, device=self.device) + (end - keep)) % self.capacity
        else:
            idx = torch.arange(n - keep, n, device=self.device)
        new_buf.add_batch(new_state, *self.gather(state, idx))
        return new_buf, new_state

    def __len__(self):
        raise TypeError("DeviceReplayBuffer keeps its count on the device; use int(state.num_stored)")


class DeviceTransitionDataset:
    """Incrementally-synced device mirror of a host replay buffer.

    The device holds the dataset once: each sync uploads ONLY the new
    transitions (one small host-to-device copy per model retraining). Capacity
    grows by copy in geometric buckets (default x1.25, rounded to 256), so the
    allocation is replaced O(log n) times over a run.
    """

    def __init__(self, obs_dim, act_dim: int, min_capacity: int = 4096,
                 growth: float = 1.25, obs_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        # obs_dim: feature count for 1-D observations, or a full obs shape
        # tuple (e.g. pixel (C, H, W)); obs_dtype uint8 keeps pixel datasets at
        # 1 byte/texel on the device
        self.device = resolve_device(device)
        self.obs_shape = (
            tuple(obs_dim) if isinstance(obs_dim, (tuple, list)) else (int(obs_dim),)
        )
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.obs_dtype = obs_dtype
        self.min_capacity = min_capacity
        self.growth = growth
        self.capacity = 0
        self.num_stored = 0
        self.data = None  # TransitionBatch of device tensors, capacity rows
        self._last_cur = 0
        self._last_total = 0

    def _bucket(self, needed: int) -> int:
        cap = max(self.min_capacity, 256)
        while cap < needed:
            cap = int(-(-cap * self.growth // 256) * 256)  # ceil to 256 multiple
        return cap

    def _alloc(self, capacity: int) -> None:
        def z(shape, dt=torch.float32):
            return torch.zeros(shape, dtype=dt, device=self.device)

        old, old_n = self.data, self.num_stored
        self.data = TransitionBatch(
            obs=z((capacity, *self.obs_shape), self.obs_dtype),
            act=z((capacity, self.act_dim)),
            next_obs=z((capacity, *self.obs_shape), self.obs_dtype),
            rewards=z((capacity,)),
            terminateds=z((capacity,), torch.bool),
            truncateds=z((capacity,), torch.bool),
        )
        self.capacity = capacity
        if old is not None and old_n:
            for dst, src in zip(self.data.astuple(), old.astuple()):
                dst[:old_n] = src[:old_n]

    def _put(self, start: int, batch) -> None:
        for dst, src in zip(self.data.astuple(), batch.astuple()):
            src = torch.as_tensor(np.asarray(src)).to(device=self.device, dtype=dst.dtype)
            dst[start : start + src.shape[0]] = src.reshape((-1,) + tuple(dst.shape[1:]))

    def append(self, batch) -> None:
        """Append host transitions (TransitionBatch of numpy arrays) at the tail;
        grows the device allocation to the next bucket when needed."""
        k = int(np.shape(batch.obs)[0])
        if k == 0:
            return
        if self.num_stored + k > self.capacity:
            self._alloc(self._bucket(self.num_stored + k))
        self._put(self.num_stored, batch)
        self.num_stored += k

    def overwrite(self, start: int, batch) -> None:
        """Overwrite rows [start, start+k) in place (post-wrap ring updates)."""
        if int(np.shape(batch.obs)[0]) == 0:
            return
        self._put(start, batch)

    def sync_from(self, replay_buffer) -> None:
        """Mirror a host ReplayBuffer's physical rows, uploading only the rows
        written since the last sync (pre-wrap: a tail append; post-wrap: at most
        two contiguous overwritten slices of the ring)."""
        n, cur = replay_buffer.num_stored, int(replay_buffer.cur_idx)
        prev_cur = self._last_cur
        total = getattr(replay_buffer, "total_added", None)
        prev_total = self._last_total
        if n < self.num_stored:  # host buffer was reset/reloaded: mirror afresh
            self.capacity = 0
            self.num_stored = 0
            self.data = None
            prev_cur = 0
        elif (
            total is not None
            and self.num_stored
            and total - prev_total >= replay_buffer.num_stored
            and not (n > self.num_stored and cur == n)
        ):
            # a full buffer's worth (or more) of writes landed since the last
            # sync AND the ring wrapped: the [cur, prev_cur) region the
            # incremental path would skip was overwritten too, or cur lapped
            # back to prev_cur exactly, which the "nothing new" shortcut would
            # treat as unchanged. Re-mirror everything.
            self._last_total = total
            self._last_cur = cur
            if n > self.num_stored:
                self.append(replay_buffer.get_range(self.num_stored, n))
            self.overwrite(0, replay_buffer.get_range(0, n))
            return
        if total is not None:
            self._last_total = total
        if n > self.num_stored and cur == n:
            # un-wrapped ring: new rows are a pure tail append
            self.append(replay_buffer.get_range(self.num_stored, n))
        elif n == self.num_stored and cur == prev_cur:
            pass  # nothing new
        else:
            # wrapped ring: physical rows [prev_cur, cur) (mod capacity) changed
            if self.num_stored < n:
                self.append(replay_buffer.get_range(self.num_stored, n))
            if cur >= prev_cur:
                self.overwrite(prev_cur, replay_buffer.get_range(prev_cur, cur))
            else:
                self.overwrite(prev_cur, replay_buffer.get_range(prev_cur, n))
                self.overwrite(0, replay_buffer.get_range(0, cur))
        self._last_cur = cur
