"""The port's replay buffer, iterators and device dataset against mbrl_tpu's:
with the same numpy ``Generator`` seed both give the same batches exactly, and
``replay_buffer.npz`` and ``model.pkl`` written by one package load in the other."""
import warnings

import jax
import numpy as np
import pytest
import torch

from mbrl_tpu.models import GaussianMLP as JaxGaussianMLP
from mbrl_tpu.models import TransitionRewardModel as JaxTRM
from mbrl_tpu.util import common as jcommon
from mbrl_tpu.util import replay_buffer as jrb
from mbrl_tpu.util.device_buffer import DeviceTransitionDataset as JaxDataset
from mbrl_tpu_torch.models import GaussianMLP, TransitionRewardModel
from mbrl_tpu_torch.types import TransitionBatch, transition_batch_like
from mbrl_tpu_torch.util import common as tcommon
from mbrl_tpu_torch.util import replay_buffer as trb
from mbrl_tpu_torch.util.device_buffer import DeviceTransitionDataset

OBS, ACT = 3, 2


def _pair(capacity, seed=0, **kw):
    return tuple(mod.ReplayBuffer(capacity, (OBS,), (ACT,), rng=np.random.default_rng(seed), **kw)
                 for mod in (jrb, trb))


def _fill(bufs, n, seed=1, done_every=None):
    rng = np.random.default_rng(seed)
    for i in range(n):
        obs, act, nxt = rng.normal(size=OBS), rng.normal(size=ACT), rng.normal(size=OBS)
        done = bool(done_every and (i + 1) % done_every == 0)
        for b in bufs:
            b.add(obs, act, nxt, float(i), done, False)


def _same(a, b):
    for x, y in zip(a.astuple(), b.astuple()):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_ring_add_batch_sample_and_ranges_are_identical():
    jb, tb = _pair(10)
    _fill((jb, tb), 7)
    rng = np.random.default_rng(5)
    arrs = (rng.normal(size=(6, OBS)), rng.normal(size=(6, ACT)), rng.normal(size=(6, OBS)),
            rng.normal(size=6), np.zeros(6, bool), np.ones(6, bool))
    for b in (jb, tb):
        b.add_batch(*arrs)
    assert (tb.cur_idx, tb.num_stored, tb.total_added) == (jb.cur_idx, jb.num_stored,
                                                            jb.total_added) == (3, 10, 13)
    _same(tb.get_all(), jb.get_all())
    _same(tb.get_range(2, 6), jb.get_range(2, 6))
    _same(tb.sample(9), jb.sample(9))
    _same(tb.get_all(shuffle=True), jb.get_all(shuffle=True))
    assert len(tb) == 10 and not tb.stores_trajectories and tb.sample_trajectory() is None
    assert isinstance(tb.get_all(), TransitionBatch)


def test_trajectory_bookkeeping_is_identical():
    jb, tb = _pair(20, max_trajectory_length=6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _fill((jb, tb), 47, done_every=5)
    assert tb.trajectory_indices == jb.trajectory_indices and tb.trajectory_indices
    assert (tb.cur_idx, tb.num_stored) == (jb.cur_idx, jb.num_stored)
    _same(tb.sample_trajectory(), jb.sample_trajectory())
    for b in (jb, tb):
        b.close_trajectory()
    assert tb.trajectory_indices == jb.trajectory_indices


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_replay_buffer_npz_crosses_packages(writer, tmp_path):
    jb, tb = _pair(30, max_trajectory_length=5)
    _fill((jb, tb), 22, done_every=4)
    (jb if writer == "jax" else tb).save(tmp_path)
    jnew, tnew = _pair(30, max_trajectory_length=5)
    reader = tnew if writer == "jax" else jnew
    reader.load(tmp_path)
    assert reader.num_stored == 22 and reader.total_added == 22
    _same(reader.get_all(), jb.get_all())
    assert [tuple(map(int, t)) for t in reader.trajectory_indices] == jb.trajectory_indices
    with np.load(tmp_path / "replay_buffer.npz") as data:
        assert sorted(data.keys()) == ["action", "next_obs", "obs", "reward", "terminated",
                                       "trajectory_indices", "truncated"]


def _epochs(it, n=2):
    return [[b for b in it] for _ in range(n)]


@pytest.mark.parametrize("shuffle", [False, True])
def test_transition_iterator_batches_are_identical(shuffle):
    jb, tb = _pair(50)
    _fill((jb, tb), 23)
    its = [mod.TransitionIterator(buf.get_all(), 5, shuffle_each_epoch=shuffle,
                                  rng=np.random.default_rng(3))
           for mod, buf in ((jrb, jb), (trb, tb))]
    assert len(its[1]) == len(its[0]) == 5 and its[1].ensemble_size == 0
    for je, te in zip(_epochs(its[0]), _epochs(its[1])):
        assert [len(b) for b in te] == [5, 5, 5, 5, 3]
        for x, y in zip(je, te):
            _same(y, x)


@pytest.mark.parametrize("permute", [True, False])
def test_bootstrap_iterator_batches_are_identical(permute):
    jb, tb = _pair(50)
    _fill((jb, tb), 24)
    its = [mod.BootstrapIterator(buf.get_all(), 6, 4, shuffle_each_epoch=True,
                                 permute_indices=permute, rng=np.random.default_rng(4))
           for mod, buf in ((jrb, jb), (trb, tb))]
    np.testing.assert_array_equal(its[1].member_indices, its[0].member_indices)
    for je, te in zip(_epochs(its[0]), _epochs(its[1])):
        assert te[0].obs.shape == (4, 6, OBS) and te[0].rewards.shape == (4, 6)
        for x, y in zip(je, te):
            _same(y, x)
    for it in its:
        it.toggle_bootstrap()
    jfirst, tfirst = next(iter(its[0])), next(iter(its[1]))
    _same(tfirst, jfirst)
    assert tfirst.obs.shape == (6, OBS)
    js, ts = jrb.stack_iterator(its[0]), trb.stack_iterator(its[1])
    assert ts.obs.shape == (4, 6, OBS)
    _same(ts, js)


def test_sequence_iterators_are_identical():
    jb, tb = _pair(60, max_trajectory_length=10)
    _fill((jb, tb), 40, done_every=8)
    kw = dict(batch_size=3, sequence_length=4)
    its = [mod.SequenceTransitionIterator(buf.get_all(), buf.trajectory_indices, ensemble_size=2,
                                          shuffle_each_epoch=True, rng=np.random.default_rng(6),
                                          max_batches_per_loop=4, **kw)
           for mod, buf in ((jrb, jb), (trb, tb))]
    assert len(its[1]) == len(its[0]) == 4
    for je, te in zip(_epochs(its[0]), _epochs(its[1])):
        assert te[0].obs.shape == (2, 3, 4, OBS)
        for x, y in zip(je, te):
            _same(y, x)
    samplers = [mod.SequenceTransitionSampler(buf.get_all(), buf.trajectory_indices,
                                              batches_per_loop=3, rng=np.random.default_rng(7), **kw)
                for mod, buf in ((jrb, jb), (trb, tb))]
    for je, te in zip(_epochs(samplers[0]), _epochs(samplers[1])):
        assert len(te) == 3 and te[0].obs.shape == (3, 4, OBS)
        for x, y in zip(je, te):
            _same(y, x)
    with pytest.warns(UserWarning, match="50%"):
        trb.SequenceTransitionIterator(tb.get_all(), tb.trajectory_indices, 3, 9, 1)


def test_basic_buffer_iterators_and_sequence_builder_are_identical():
    jb, tb = _pair(80, seed=9, max_trajectory_length=10)
    _fill((jb, tb), 50, done_every=10)
    (jt, jv), (tt, tv) = (mod.get_basic_buffer_iterators(buf, 8, 0.2, ensemble_size=3)
                          for mod, buf in ((jcommon, jb), (tcommon, tb)))
    assert tv.num_stored == jv.num_stored == 10 and tt.num_stored == 40
    _same(trb.stack_iterator(tt), jrb.stack_iterator(jt))
    _same(tv.transitions, jv.transitions)
    assert tcommon.get_basic_buffer_iterators(tb, 8, 0.0)[1] is None
    assert jcommon.get_basic_buffer_iterators(jb, 8, 0.0)[1] is None  # keeps the two rngs in step
    (jt, jv), (tt, tv) = (mod.get_sequence_buffer_iterator(buf, 4, 0.25, 5, ensemble_size=2)
                          for mod, buf in ((jcommon, jb), (tcommon, tb)))
    _same(trb.stack_iterator(tt), jrb.stack_iterator(jt))
    _same(next(iter(tv)), next(iter(jv)))


def test_transition_batch_methods():
    rng = np.random.default_rng(0)
    batch = transition_batch_like(rng.normal(size=(6, OBS)), rng.normal(size=(6, ACT)))
    assert len(batch) == 6 and batch.shape == (6, OBS) and batch.rewards.shape == (6, 1)
    assert batch[2:4].act.shape == (2, ACT) and len(batch.astuple()) == 6
    split = batch.add_new_batch_dim(3)
    assert split.obs.shape == (2, 3, OBS) and split.terminateds.shape == (2, 3, 1)
    with pytest.raises(ValueError):
        batch.add_new_batch_dim(4)
    dev = batch.to("cpu")
    assert dev.obs.dtype == torch.float32 and dev.terminateds.dtype == torch.bool
    assert dev.to("cpu", torch.float64).act.dtype == torch.float64
    assert dev.add_new_batch_dim(2).obs.shape == (3, 2, OBS) and dev[1].obs.shape == (OBS,)


# --------------------------------------------------------------------------- #
# the device dataset
# --------------------------------------------------------------------------- #
def _mirrors(tb, ds, jds):
    n = tb.num_stored
    host = tb.get_all()
    assert ds.num_stored == n == jds.num_stored and ds.capacity == jds.capacity
    for got, ref, want in zip(ds.data.astuple(), jds.data.astuple(), host.astuple()):
        np.testing.assert_allclose(got[:n].numpy(), np.asarray(want), rtol=1e-6)
        np.testing.assert_array_equal(got[:n].numpy(), np.asarray(ref[:n]))


@pytest.mark.parametrize("needed", [1, 64, 65, 300, 4096, 4097, 20_000])
def test_dataset_bucket_matches_the_reference(needed):
    for min_capacity in (64, 4096):
        assert (DeviceTransitionDataset(OBS, ACT, min_capacity=min_capacity, device="cpu")._bucket(needed)
                == JaxDataset(OBS, ACT, min_capacity=min_capacity)._bucket(needed))


def test_sync_append_wrapped_ring_and_full_lap():
    jb, tb = _pair(64)
    ds = DeviceTransitionDataset(OBS, ACT, min_capacity=64, device="cpu")
    jds = JaxDataset(OBS, ACT, min_capacity=64)

    def sync():
        ds.sync_from(tb)
        jds.sync_from(jb)
        _mirrors(tb, ds, jds)

    _fill((jb, tb), 40, seed=1)
    sync()                              # a pure tail append
    sync()                              # nothing new
    _fill((jb, tb), 20, seed=2)
    sync()                              # another append, not yet wrapped
    _fill((jb, tb), 20, seed=3)
    sync()                              # the ring wrapped: append + overwrite of [0, 16)
    _fill((jb, tb), 10, seed=4)
    sync()                              # wrapped, one contiguous slice
    _fill((jb, tb), 60, seed=5)
    sync()                              # wrapped twice over the end: two slices
    _fill((jb, tb), 64, seed=6)
    sync()                              # a full lap: cur is back where it was
    _fill((jb, tb), 64 * 2 + 5, seed=7)
    sync()                              # more than a lap
    assert ds.data.obs.dtype == torch.float32 and ds.data.terminateds.dtype == torch.bool
    # the host buffer reloaded with fewer rows: mirrored afresh
    small_j, small_t = _pair(64)
    _fill((small_j, small_t), 12, seed=8)
    ds.sync_from(small_t)
    assert ds.num_stored == 12
    np.testing.assert_allclose(ds.data.obs[:12].numpy(), small_t.get_all().obs, rtol=1e-6)


def test_dataset_grows_by_copy_in_buckets():
    _, tb = _pair(4096)
    _fill((tb,), 100)
    ds = DeviceTransitionDataset(OBS, ACT, min_capacity=256, device="cpu")
    ds.sync_from(tb)
    assert ds.capacity == 256
    first = ds.data.obs[:100].clone()
    for _ in range(3):
        ds.append(tb.get_range(0, 100))
    assert ds.num_stored == 400 and ds.capacity >= 400 and ds.capacity % 256 == 0
    assert torch.equal(ds.data.obs[:100], first) and torch.equal(ds.data.obs[300:400], first)
    ds.overwrite(5, tb.get_range(50, 60))
    assert torch.equal(ds.data.obs[5:15], first[50:60])
    ds.append(tb.get_range(0, 0))
    assert ds.num_stored == 400
    with pytest.raises(RuntimeError, match="cuda"):
        if torch.cuda.is_available():
            raise RuntimeError("cuda present")
        DeviceTransitionDataset(OBS, ACT)


# --------------------------------------------------------------------------- #
# model.pkl
# --------------------------------------------------------------------------- #
def _models():
    kw = dict(in_size=OBS + ACT, out_size=OBS + 1, num_layers=2, ensemble_size=3, hid_size=8)
    jw = JaxTRM(JaxGaussianMLP(**kw), normalize=True, num_elites=2)
    tw = TransitionRewardModel(GaussianMLP(device="cpu", **kw), normalize=True, num_elites=2)
    return jw, tw


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_model_pkl_crosses_packages(writer, tmp_path):
    jw, tw = _models()
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(30, OBS)).astype(np.float32), rng.normal(size=(30, ACT)).astype(np.float32))
    x = rng.normal(size=(5, OBS + ACT)).astype(np.float32)
    jstate = jw.init(jax.random.PRNGKey(1))
    tstate = tw.init(torch.Generator().manual_seed(1))
    if writer == "jax":
        from mbrl_tpu.types import transition_batch_like as jlike

        jstate = jw.set_elite(jw.update_normalizer(jstate, jlike(*batch)), [2, 0])
        jw.save(jstate, tmp_path)
        loaded = tw.load(tstate, tmp_path)
        assert loaded["params"]["elite"].tolist() == [2, 0]
        assert loaded["params"]["elite"].dtype == torch.int64
    else:
        tstate = tw.set_elite(tw.update_normalizer(tstate, transition_batch_like(*batch)), [2, 0])
        tstate["opt_state"] = {"not": "saved"}
        tw.save(tstate, tmp_path)
        loaded = jw.load(jstate, tmp_path)
        assert np.asarray(loaded["params"]["elite"]).tolist() == [2, 0]
        jstate = loaded
        loaded = tw.load(tw.init(torch.Generator().manual_seed(2)), tmp_path)
    assert "opt_state" not in loaded
    import jax.numpy as jnp

    jmean, jlv = jw.model.forward(jstate["params"], jnp.asarray(x))
    tmean, tlv = tw.model.forward(loaded["params"], torch.from_numpy(x))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(loaded["normalizer"].mean.numpy(), np.asarray(jstate["normalizer"].mean),
                               rtol=1e-6)
    np.testing.assert_allclose(loaded["normalizer"].std.numpy(), np.asarray(jstate["normalizer"].std),
                               rtol=1e-6)
