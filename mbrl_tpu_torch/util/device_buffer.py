"""Device-resident transition dataset (counterpart of
``mbrl_tpu/util/device_buffer.py``).

``DeviceTransitionDataset`` mirrors a host ``ReplayBuffer`` in device memory
for ``ModelTrainer.train_device``: each sync moves only the rows written since
the last one. ``DeviceReplayBuffer`` (MBPO's SAC buffer) comes with the MBPO
slice.
"""
from __future__ import annotations

import numpy as np
import torch

from mbrl_tpu_torch.device import DeviceLike, resolve_device
from mbrl_tpu_torch.types import TransitionBatch


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
