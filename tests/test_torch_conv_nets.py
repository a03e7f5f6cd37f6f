"""The port's conv encoder and decoder (``mbrl_tpu_torch/models/conv_nets.py``)
against mbrl_tpu's on the same weights, on the CPU.

At ``dynamics_model/planet.yaml``'s full configuration (3x64x64 pixels, four
convs to 256x2x2 = 1,024, the identity head; a 1,024 -> 1x1 linear layer and
four deconvs 1 -> 5 -> 13 -> 30 -> 64), batch 3, with random biases so that
nothing cancels. Tolerance: 1e-5 relative to the largest output (float32 sums
of up to 4,096 products in two libraries). The decoder's deconv weights are
(in_ch, out_ch, k, k) in both packages; a spatially flipped kernel is shown
to disagree, so the agreement pins the layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mbrl_tpu.models.conv_nets import Conv2dDecoder as JaxDecoder
from mbrl_tpu.models.conv_nets import Conv2dEncoder as JaxEncoder
from mbrl_tpu.models.conv_nets import conv_output_shape as jax_conv_output_shape
from mbrl_tpu_torch.models import Conv2dDecoder, Conv2dEncoder
from mbrl_tpu_torch.models.conv_nets import conv_output_shape
from mbrl_tpu_torch.ops.tree import tree_map

OBS = (3, 64, 64)
ENC = [(3, 32, 4, 2), (32, 64, 4, 2), (64, 128, 4, 2), (128, 256, 4, 2)]
DEC_IN = (1024, 1, 1)
DEC = [(1024, 128, 5, 2), (128, 64, 5, 2), (64, 32, 6, 2), (32, 3, 6, 2)]
LATENT, BELIEF = 30, 200
B = 3


def _random_params(shapes, seed):
    """Numpy params of the given shapes (the JAX package's layout): weights
    uniform at the Xavier bound of their fans, biases nonzero so that nothing
    cancels. (Drawn here: the JAX package's eager ``init`` at full width takes
    seconds.)"""
    rng = np.random.default_rng(seed)

    def draw(tree):
        if isinstance(tree, dict):
            return {k: draw(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [draw(v) for v in tree]
        if len(tree) == 1:
            return (0.1 * rng.standard_normal(tree)).astype(np.float32)
        fan = np.prod(tree[2:], dtype=np.int64) if len(tree) == 4 else 1
        bound = np.sqrt(6.0 / ((tree[0] + tree[1]) * fan))
        return rng.uniform(-bound, bound, tree).astype(np.float32)

    return draw(shapes)


def _encoder_shapes(layers, fc=None):
    shapes = {"convs": [{"w": (o, i, k, k), "b": (o,)} for i, o, k, _ in layers]}
    if fc is not None:
        shapes["fc"] = {"w": fc, "b": (fc[1],)}
    return shapes


def _decoder_shapes(encoding, deconv_in, layers):
    return {"fc": {"w": (encoding, int(np.prod(deconv_in))), "b": (int(np.prod(deconv_in)),)},
            "deconvs": [{"w": (i, o, k, k), "b": (o,)} for i, o, k, _ in layers]}


def _torch(tree):
    return tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


def _close(got: torch.Tensor, want, rel=1e-5):
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert got.shape == want.shape
    assert err <= rel * float(np.abs(want).max()), err


def test_conv_output_shape_matches_jax():
    assert conv_output_shape(OBS[1:], ENC) == jax_conv_output_shape(OBS[1:], ENC) == (256, 2, 2)
    assert conv_output_shape((32, 32), ENC[:2]) == jax_conv_output_shape((32, 32), ENC[:2])


@pytest.mark.parametrize("encoding", [1024, 200], ids=["identity_head", "linear_head"])
def test_encoder_at_full_width_matches_jax(encoding):
    jenc = JaxEncoder(ENC, OBS[1:], encoding)
    enc = Conv2dEncoder(ENC, OBS[1:], encoding, device="cpu")
    assert enc.identity_head == jenc.identity_head == (encoding == 1024)
    params = _random_params(_encoder_shapes(ENC, None if encoding == 1024 else (1024, encoding)), 1)
    obs = np.random.default_rng(2).uniform(-0.5, 0.5, (B,) + OBS).astype(np.float32)
    want = jenc.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(obs))
    got = enc.apply(_torch(params), torch.as_tensor(obs))
    assert got.shape == (B, encoding)
    _close(got, want)


def test_decoder_at_full_width_matches_jax_and_pins_the_deconv_layout():
    jdec = JaxDecoder(LATENT + BELIEF, DEC_IN, DEC)
    dec = Conv2dDecoder(LATENT + BELIEF, DEC_IN, DEC, device="cpu")
    params = _random_params(_decoder_shapes(LATENT + BELIEF, DEC_IN, DEC), 4)
    x = np.random.default_rng(5).standard_normal((B, LATENT + BELIEF)).astype(np.float32)
    want = np.asarray(jdec.apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x)))
    got = dec.apply(_torch(params), torch.as_tensor(x))
    assert got.shape == (B,) + OBS
    _close(got, want)
    # each deconv's output size: (in - 1) * s + k
    sizes, h = [], 1
    for _, _, k, s in DEC:
        h = (h - 1) * s + k
        sizes.append(h)
    assert sizes == [5, 13, 30, 64]
    # a flipped kernel would be wrong: the layout is what the agreement tests
    flipped = _torch(params)
    flipped["deconvs"][1]["w"] = torch.flip(flipped["deconvs"][1]["w"], dims=(2, 3))
    err = float(np.abs(dec.apply(flipped, torch.as_tensor(x)).numpy() - want).max())
    assert err > 1e-3 * float(np.abs(want).max())


def test_encoder_and_decoder_gradients_match_jax():
    """The input gradient of a scalar through the encoder, then the decoder,
    at a narrow configuration (the full one's products are checked above)."""
    enc_cfg, dec_cfg = [(3, 8, 4, 2), (8, 16, 4, 2)], [(64, 32, 5, 1), (32, 16, 6, 2), (16, 3, 6, 2)]
    jenc, jdec = JaxEncoder(enc_cfg, (32, 32), 64), JaxDecoder(64, (64, 1, 1), dec_cfg)
    enc = Conv2dEncoder(enc_cfg, (32, 32), 64, device="cpu")
    dec = Conv2dDecoder(64, (64, 1, 1), dec_cfg, device="cpu")
    pe = _random_params(_encoder_shapes(enc_cfg, (16 * 6 * 6, 64)), 7)
    pd = _random_params(_decoder_shapes(64, (64, 1, 1), dec_cfg), 9)
    obs = np.random.default_rng(10).uniform(-0.5, 0.5, (2, 3, 32, 32)).astype(np.float32)

    def jloss(o):
        recon = jdec.apply(jax.tree_util.tree_map(jnp.asarray, pd),
                           jenc.apply(jax.tree_util.tree_map(jnp.asarray, pe), o))
        return jnp.sum(jnp.square(recon - o))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(obs)))
    x = torch.as_tensor(obs).requires_grad_(True)
    torch.sum(torch.square(dec.apply(_torch(pd), enc.apply(_torch(pe), x)) - x)).backward()
    _close(x.grad, want)


def test_init_layouts_and_bounds():
    """The port's init gives the JAX package's layout, with Xavier bounds."""
    g = torch.Generator().manual_seed(0)
    enc = Conv2dEncoder(ENC, OBS[1:], 200, device="cpu")
    dec = Conv2dDecoder(LATENT + BELIEF, DEC_IN, DEC, device="cpu")
    assert tree_map(lambda t: tuple(t.shape), enc.init(g)) == _encoder_shapes(ENC, (1024, 200))
    assert tree_map(lambda t: tuple(t.shape), dec.init(g)) == _decoder_shapes(
        LATENT + BELIEF, DEC_IN, DEC)
    assert "fc" not in Conv2dEncoder(ENC, OBS[1:], 1024, device="cpu").init(g)
    w = dec.init(g)["deconvs"][0]["w"]
    bound = np.sqrt(6.0 / (1024 * 25 + 128 * 25))
    assert float(w.abs().max()) <= bound and float(w.std()) > 0.5 * bound / np.sqrt(3)
