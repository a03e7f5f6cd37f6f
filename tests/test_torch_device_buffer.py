"""The port's ``DeviceReplayBuffer`` (MBPO's SAC buffer) against mbrl_tpu's, on
the CPU: after the same writes every array and both counters are equal,
exactly (``add_batch`` with a wrap, ``add_batch_masked`` with invalid rows and
a wrap, ``resize`` growing, shrinking, of a wrapped and an unwrapped ring).
The scratch row at index ``capacity`` takes the masked-out writes in any
order, so it is left out of the comparison. Sampling draws differ between the
packages; its indices are checked to stay below ``num_stored``."""
import numpy as np
import pytest
import torch

from mbrl_tpu.util.device_buffer import DeviceReplayBuffer as JaxBuffer
from mbrl_tpu_torch.util.device_buffer import DeviceReplayBuffer, uniform_indices

OBS, ACT = 3, 2


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, OBS)).astype(np.float32),
            rng.standard_normal((n, ACT)).astype(np.float32),
            rng.standard_normal((n, OBS)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            (rng.random(n) > 0.3).astype(np.float32))


def _assert_same(jbuf, jst, tbuf, tst):
    assert tbuf.capacity == jbuf.capacity
    cap = tbuf.capacity
    for name in ("obs", "act", "next_obs", "reward", "mask"):
        np.testing.assert_array_equal(getattr(tst, name)[:cap].numpy(),
                                      np.asarray(getattr(jst, name))[:cap], err_msg=name)
    assert int(tst.cur_idx) == int(jst.cur_idx)
    assert int(tst.num_stored) == int(jst.num_stored)


def _pair(capacity):
    jbuf, tbuf = JaxBuffer(capacity, OBS, ACT), DeviceReplayBuffer(capacity, OBS, ACT, device="cpu")
    return jbuf, jbuf.init(), tbuf, tbuf.init()


def test_add_batch_and_wrap():
    jbuf, jst, tbuf, tst = _pair(10)
    for n, seed in ((8, 0), (4, 1), (3, 2)):  # the second wraps
        rows = _rows(n, seed)
        jst = jbuf.add_batch(jst, *rows)
        tst = tbuf.add_batch(tst, *rows)
        _assert_same(jbuf, jst, tbuf, tst)
    assert int(tst.cur_idx) == 5 and int(tst.num_stored) == 10


def test_add_batch_longer_than_the_ring_keeps_its_last_rows():
    jbuf, jst, tbuf, tst = _pair(6)
    rows = _rows(9, 3)
    jst = jbuf.add_batch(jst, *rows)
    tst = tbuf.add_batch(tst, *rows)
    _assert_same(jbuf, jst, tbuf, tst)


@pytest.mark.parametrize("start", [0, 5], ids=["empty", "wraps"])
def test_add_batch_masked(start):
    jbuf, jst, tbuf, tst = _pair(8)
    if start:
        rows = _rows(start, 4)
        jst = jbuf.add_batch(jst, *rows)
        tst = tbuf.add_batch(tst, *rows)
    valid = np.array([True, False, True, True, False, True, True])
    rows = _rows(len(valid), 5)
    jst = jbuf.add_batch_masked(jst, *rows, valid)
    tst = tbuf.add_batch_masked(tst, *rows, torch.from_numpy(valid))
    _assert_same(jbuf, jst, tbuf, tst)
    assert int(tst.num_stored) == min(start + 5, 8) and int(tst.cur_idx) == (start + 5) % 8
    # the valid rows landed in order, the invalid ones only in the scratch row
    got = [tst.obs[(start + i) % 8].tolist() for i in range(5)]
    assert got == rows[0][valid].tolist()


@pytest.mark.parametrize("stored,new_capacity", [(9, 4), (9, 10), (3, 2), (3, 8), (0, 5)],
                         ids=["wrapped-shrink", "wrapped-grow", "shrink", "grow", "empty"])
def test_resize_keeps_the_newest_rows_in_order(stored, new_capacity):
    jbuf, jst, tbuf, tst = _pair(6)
    if stored:
        rows = _rows(stored, 6)
        jst = jbuf.add_batch(jst, *rows)
        tst = tbuf.add_batch(tst, *rows)
    jbuf2, jst2 = jbuf.resize(jst, new_capacity)
    tbuf2, tst2 = tbuf.resize(tst, new_capacity)
    _assert_same(jbuf2, jst2, tbuf2, tst2)


def test_sampling_stays_below_num_stored_and_never_reads_back():
    tbuf = DeviceReplayBuffer(100, OBS, ACT, device="cpu")
    tst = tbuf.init()
    rows = _rows(6, 7)
    tst = tbuf.add_batch_masked(tst, *rows, torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.bool))
    g = torch.Generator().manual_seed(0)
    idx = uniform_indices(g, (2000,), tst.num_stored)
    assert int(idx.min()) == 0 and int(idx.max()) == 3
    o, a, no, r, m = tbuf.sample(tst, g, 32)
    assert o.shape == (32, OBS) and a.shape == (32, ACT) and r.shape == (32, 1) and m.shape == (32, 1)
    stacked = tbuf.sample_many(tst, g, 3, 16)
    assert stacked[0].shape == (3, 16, OBS) and stacked[4].shape == (3, 16, 1)
    # an empty buffer samples row 0, as jax.random.randint(0, max(n, 1)) does
    assert int(uniform_indices(g, (50,), tbuf.init().num_stored).max()) == 0
    with pytest.raises(TypeError):
        len(tbuf)


def test_counters_stay_zero_dimensional_tensors():
    tbuf = DeviceReplayBuffer(5, OBS, ACT, device="cpu")
    tst = tbuf.add_batch(tbuf.init(), *_rows(2, 8))
    for counter in (tst.cur_idx, tst.num_stored):
        assert isinstance(counter, torch.Tensor) and counter.dim() == 0
