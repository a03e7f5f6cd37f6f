"""The port's math functions and normalizer against mbrl_tpu (CPU).

Same numpy inputs on both sides. Tolerances: 1e-6 for gaussian_nll,
truncated_linear and propagate*; 1e-5 for powerlaw_psd_gaussian given the same
two normal draws; 1e-12 for the float64 normalizer statistics against numpy
(JAX runs without x64 here, so its float32 statistics are held to 1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbrl_tpu.ops import math as jmath
from mbrl_tpu.ops import normalizer as jnrm
from mbrl_tpu_torch.ops import math as tmath
from mbrl_tpu_torch.ops import normalizer as nrm


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("reduce", [True, False])
def test_gaussian_nll_matches_jax(reduce):
    rng = np.random.default_rng(0)
    mean, logvar, target = (rng.standard_normal((3, 7, 4)).astype(np.float32) for _ in range(3))
    want = jmath.gaussian_nll(jnp.asarray(mean), jnp.asarray(logvar), jnp.asarray(target), reduce)
    got = tmath.gaussian_nll(*(torch.from_numpy(a) for a in (mean, logvar, target)), reduce=reduce)
    _close(got, want, 1e-6 if not reduce else 1e-5)


@pytest.mark.parametrize("x", [-1.0, 0.0, 2.5, 5.0, 10.0, 20.0])
def test_truncated_linear_matches_jax(x):
    assert tmath.truncated_linear(0.0, 10.0, 1.0, 5.0, x) == jmath.truncated_linear(
        0.0, 10.0, 1.0, 5.0, x)
    assert tmath.truncated_linear(3.0, 3.0, 1.0, 5.0, x) == 5.0  # degenerate x range


def test_propagate_matches_jax():
    rng = np.random.default_rng(1)
    preds = tuple(rng.standard_normal((4, 9, 3)).astype(np.float32) for _ in range(2))
    idx = rng.integers(0, 4, size=9)
    jp = tuple(jnp.asarray(p) for p in preds)
    tp = tuple(torch.from_numpy(p) for p in preds)
    _close(tmath.propagate_from_indices(tp[0], torch.from_numpy(idx)),
           jmath.propagate_from_indices(jp[0], jnp.asarray(idx)), 1e-6)
    for got, want in zip(tmath.propagate(tp, "fixed_model", torch.from_numpy(idx)),
                         jmath.propagate(jp, "fixed_model", jnp.asarray(idx))):
        _close(got, want, 1e-6)
    for got, want in zip(tmath.propagate(tp, "expectation"), jmath.propagate(jp, "expectation")):
        _close(got, want, 1e-6)
    # random_model: every row comes from one of the members, each prediction drawn anew
    g = torch.Generator().manual_seed(0)
    for got, p in zip(tmath.propagate(tp, "random_model", generator=g), tp):
        assert got.shape == (9, 3)
        assert bool(((got[None] == p).all(-1)).any(0).all())
    with pytest.raises(ValueError):
        tmath.propagate(tp, "random_model")
    with pytest.raises(ValueError):
        tmath.propagate(tp, "fixed_model")
    with pytest.raises(ValueError):
        tmath.propagate(tp, "nope")


def _jax_powerlaw_from_normals(nr, ni, exponent, samples, fmin=0.0):
    """mbrl_tpu's powerlaw_psd_gaussian with its two normal draws replaced by
    the given arrays (jax.random.normal patched for the call)."""
    draws = iter([jnp.asarray(nr), jnp.asarray(ni)])
    orig = jax.random.normal
    jax.random.normal = lambda key, shape, *a, **k: next(draws)
    try:
        return jmath.powerlaw_psd_gaussian(jax.random.PRNGKey(0), exponent,
                                           tuple(nr.shape[:-1]) + (samples,), fmin)
    finally:
        jax.random.normal = orig


@pytest.mark.parametrize("samples", [16, 15, 2, 3])
@pytest.mark.parametrize("exponent", [0.0, 1.0, 2.0])
def test_powerlaw_matches_jax_on_the_same_draws(samples, exponent):
    rng = np.random.default_rng(samples)
    shape = (5, 3, samples // 2 + 1)
    nr, ni = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    want = _jax_powerlaw_from_normals(nr, ni, exponent, samples)
    got = tmath._powerlaw_from_normals(torch.from_numpy(nr.copy()), torch.from_numpy(ni.copy()),
                                       exponent, samples)
    assert got.shape == (5, 3, samples)
    _close(got, want, 1e-5)


def test_powerlaw_single_sample_is_a_plain_gaussian():
    g = torch.Generator().manual_seed(0)
    out = tmath.powerlaw_psd_gaussian(g, 2.0, (4000, 2, 1))
    assert out.shape == (4000, 2, 1)
    assert abs(float(out.mean())) < 0.05 and abs(float(out.var()) - 1.0) < 0.1
    want = torch.randn((3, 1), generator=torch.Generator().manual_seed(5))
    _close(tmath.powerlaw_psd_gaussian(torch.Generator().manual_seed(5), 2.0, (3, 1)), want, 0)
    assert tmath.powerlaw_psd_gaussian(g, 1.0, 8).shape == (8,)  # an int size


@pytest.mark.parametrize("exponent,slope", [(0.0, 0.0), (1.0, -1.0), (2.0, -2.0)])
def test_powerlaw_has_unit_variance_and_the_spectrum_slope(exponent, slope):
    g = torch.Generator().manual_seed(1)
    x = tmath.powerlaw_psd_gaussian(g, exponent, (4000, 128))
    # the theoretical sigma leaves the DC term out: each series has unit
    # variance about its own mean, and the whole is close to it
    within = (x - x.mean(-1, keepdim=True)).pow(2).mean()
    assert abs(float(within) - 1.0) < 0.02, within
    assert abs(float(x.std()) - 1.0) < 0.1
    assert abs(float(x.mean())) < 0.05
    psd = (torch.fft.rfft(x, dim=-1).abs() ** 2).mean(0)[1:-1]
    f = torch.fft.rfftfreq(128)[1:-1]
    fit = np.polyfit(np.log(f.numpy()), np.log(psd.numpy()), 1)[0]
    assert abs(fit - slope) < 0.1, fit


@pytest.mark.parametrize("host", [False, True])
def test_normalizer_float64_statistics(host):
    rng = np.random.default_rng(2)
    data = rng.standard_normal((200, 5)) * np.array([1.0, 5.0, 1e-14, 0.1, 100.0]) + 3.0
    state = nrm.init_normalizer(5, "cpu", dtype=torch.float64)
    assert state.eps == 1e-12 and state.mean.dtype == torch.float64
    new = nrm.update_stats_host(state, data) if host else nrm.update_stats(state, data)
    assert new.mean.dtype == torch.float64 and new.std.dtype == torch.float64
    std = data.std(axis=0, keepdims=True, ddof=1)
    std = np.where(std < 1e-12, 1.0, std)
    np.testing.assert_allclose(new.mean.numpy(), data.mean(axis=0, keepdims=True), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(new.std.numpy(), std, rtol=1e-12, atol=1e-12)
    assert new.std[0, 2] == 1.0  # the constant column's std is clamped to 1
    x = torch.from_numpy(rng.standard_normal((4, 5)))
    _close(nrm.denormalize(new, nrm.normalize(new, x)), x, 1e-9)


@pytest.mark.parametrize("host", [False, True])
def test_normalizer_float32_matches_jax(host):
    rng = np.random.default_rng(3)
    data = (rng.standard_normal((100, 4)) * 3 + 1).astype(np.float32)
    data[:, 1] = 2.0
    jstate = jnrm.init_normalizer(4)
    tstate = nrm.init_normalizer(4, "cpu")
    if host:
        jnew, tnew = jnrm.update_stats_host(jstate, data), nrm.update_stats_host(tstate, data)
    else:
        jnew, tnew = jnrm.update_stats(jstate, jnp.asarray(data)), nrm.update_stats(tstate, data)
    assert tnew.mean.dtype == torch.float32 and tnew.eps == 1e-5
    _close(tnew.mean, jnew.mean, 1e-5)
    _close(tnew.std, jnew.std, 1e-5)
    with pytest.raises(ValueError):
        nrm.update_stats(tstate, data[:, :3])
    with pytest.raises(ValueError):
        nrm.update_stats_host(tstate, data[0])


def test_normalizer_save_load_crosses_packages(tmp_path):
    rng = np.random.default_rng(4)
    data = rng.standard_normal((50, 3)).astype(np.float32)
    tstate = nrm.update_stats(nrm.init_normalizer(3, "cpu"), data)
    (tmp_path / "a").mkdir()
    nrm.save(tstate, tmp_path / "a")
    jloaded = jnrm.load(jnrm.init_normalizer(3), tmp_path / "a")
    _close(jloaded.mean, tstate.mean, 1e-7)
    (tmp_path / "b").mkdir()
    jnrm.save(jnrm.update_stats(jnrm.init_normalizer(3), jnp.asarray(data)), tmp_path / "b")
    tloaded = nrm.load(nrm.init_normalizer(3, "cpu", dtype=torch.float64), tmp_path / "b")
    assert tloaded.std.dtype == torch.float64
    _close(tloaded.std, tstate.std, 1e-5)
