"""The port's StyleGAN2 family against the JAX package on the CPU:
DualStyleUNetV2 in its three modes, SWGANUnet, StyleGenerator and the
Discriminator, each built by the JAX net, carried across with
``utils/convert.py`` and run on the same numpy styles, noise and images;
and each port module's state_dict round trip through the JAX package's
torch-checkpoint importer."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.models import discriminator as jdisc
from animatablegaussians_tpu.models import stylegan as jsg
from animatablegaussians_tpu.models import styleunet as jsu
from animatablegaussians_tpu.models import styleunet_v2 as jv2
from animatablegaussians_tpu.training import checkpoint as jckpt
from animatablegaussians_torch.models import discriminator as tdisc
from animatablegaussians_torch.models import stylegan as tsg
from animatablegaussians_torch.models import styleunet_v2 as tv2
from animatablegaussians_torch.utils import convert

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
# The CPU suite runs under pytest-xdist, six workers to a machine, and
# torch's default of one intra-op thread per core has every worker's torch
# ops contend for every core with the others' (and with the JAX tests'
# thread pools). Each worker imports this module when it collects the
# suite, so the cap holds for every test it runs.
torch.set_num_threads(2)

# tests/test_styleunet_v2.py's sizes
KW = dict(inp_size=64, inp_ch=3, out_ch=3, out_size=64, style_dim=64,
          n_mlp=2, middle_size=8, channel_max=32)
SD = KW["style_dim"]


@pytest.fixture(scope="module", autouse=True)
def _highest_precision():
    prev = jsu.CONV_PRECISION
    jsu.set_conv_precision("highest")
    yield
    jsu.set_conv_precision(prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def init_params(jnet, seed, lr_mul=0.01):
    """A JAX net's parameter tree as numpy arrays, drawn as its ``init``
    draws them but without compiling it (its shapes from
    ``jax.eval_shape``): weights, noise maps and the constant input
    N(0, 1), the mapping MLP's (``style``, ``mapping``) divided by its
    ``lr_mul``; biases and noise weights at their init values
    (modulation biases 1, the rest 0) plus 0.1 N(0, 1), so that every term
    is exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(seed))

    def draw(path, leaf):
        keys = [getattr(k, "key", None) for k in path]
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim >= 2:
            return x / lr_mul if keys[0] in ("style", "mapping") else x
        base = 1.0 if "modulation" in keys and keys[-1] == "bias" else 0.0
        return (base + 0.1 * x).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _build(jnet, tcls, tkw, to_state, seed):
    params = init_params(jnet, seed)
    tnet = tcls(device="cpu", **tkw)
    tnet.load_state_dict(to_state(params), strict=True)
    return jnet, params, tnet


@pytest.fixture(scope="module")
def v2_nets():
    out = {}
    for mode in jv2.DualStyleUNetV2.MODES:
        out[mode] = _build(jv2.DualStyleUNetV2(mode=mode, **KW),
                           tv2.DualStyleUNetV2, dict(mode=mode, **KW),
                           convert.dual_styleunet_v2_state, 0)
    out["c_dim"] = _build(jv2.DualStyleUNetV2(c_dim=8, **KW),
                          tv2.DualStyleUNetV2, dict(c_dim=8, **KW),
                          convert.dual_styleunet_v2_state, 2)
    out["swgan"] = _build(jv2.SWGANUnet(**KW), tv2.SWGANUnet, KW,
                          convert.swgan_unet_state, 4)
    return out


GEN_KW = dict(size=64, style_dim=SD, n_mlp=2, channel_max=32)


@pytest.fixture(scope="module")
def generator():
    return _build(jsg.StyleGenerator(**GEN_KW), tsg.StyleGenerator, GEN_KW,
                  convert.style_generator_state, 6)


DISC_KW = {"b4": dict(size=64, img_channel=6, channel_max=32),
           "c_dim": dict(size=32, img_channel=3, channel_max=16, c_dim=10),
           "b8": dict(size=32, img_channel=3, channel_max=16)}


@pytest.fixture(scope="module")
def discriminators():
    return {k: _build(jdisc.Discriminator(**kw), tdisc.Discriminator, kw,
                      convert.discriminator_state, 8 + i)
            for i, (k, kw) in enumerate(DISC_KW.items())}


def _compare(got, want):
    """float32 on both sides; the JAX side folds the resampling chains
    into polyphase convs: rtol 1e-4 of the output's scale."""
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)


def _noise(shapes, batch, rng):
    return [rng.standard_normal((batch,) + tuple(s[1:])).astype(np.float32)
            for s in shapes]


def _both(jfn, tfn, arrays, **kw):
    """Call the JAX side with jnp arrays and the port's with tensors: each
    entry of ``arrays`` is a numpy array or a list of them."""
    def conv(f):
        return {k: [f(x) for x in v] if isinstance(v, list) else f(v)
                for k, v in arrays.items()}
    want = jfn(**conv(jnp.asarray), **kw)
    with torch.no_grad():
        got = tfn(**conv(torch.as_tensor), **kw)
    return got, want


def _v2_case(jnet, params, tnet, case, rng):
    """One forward both ways: 'mix' (two styles, inject_index 3,
    truncation toward a given latent, fresh noise, cond when the net has
    c_dim), 'default_index' (two styles at the default index, the same
    host draw), 'wplus' (input_is_latent with a W+ tensor, the fixed noise
    buffers)."""
    b = 2
    arrays = dict(cond_img=rng.standard_normal(
        (b, 64, 64, 3)).astype(np.float32))
    kw = dict(return_latents=True)
    if jnet.c_dim:
        arrays["cond"] = rng.standard_normal((b, jnet.c_dim)) \
            .astype(np.float32)
    if case == "wplus":
        arrays["styles"] = [rng.standard_normal(
            (b, jnet.n_latent, SD)).astype(np.float32)]
        kw.update(input_is_latent=True, randomize_noise=False)
    else:
        arrays["styles"] = [rng.standard_normal((b, SD)).astype(np.float32)
                            for _ in range(2)]
        arrays["noise"] = _noise([n.shape for n in params["noises"]], b, rng)
    if case == "mix":
        arrays["truncation_latent"] = rng.standard_normal(
            (1, SD)).astype(np.float32)
        kw.update(inject_index=3, truncation=0.7)

    def jfn(**a):
        random.seed(11)
        return jnet.apply(params, a.pop("styles"), a.pop("cond_img"), **a)

    def tfn(**a):
        random.seed(11)
        return tnet(a.pop("styles"), a.pop("cond_img"), **a)

    return _both(jfn, tfn, arrays, **kw)


@pytest.mark.parametrize("net", ["base", "add_dwt", "wo_dwt", "c_dim"])
@pytest.mark.parametrize("case", ["mix", "default_index", "wplus"])
def test_dual_styleunet_v2_matches_jax(v2_nets, net, case):
    jnet, params, tnet = v2_nets[net]
    (img, lat), (want, want_lat) = _v2_case(
        jnet, params, tnet, case, np.random.default_rng(len(net) + 7))
    assert img.shape == (2, 64, 64, 6)
    assert lat.shape == (2, jnet.n_latent, SD) == want_lat.shape
    _compare(lat, want_lat)
    _compare(img, want)


def test_swgan_unet_matches_jax(v2_nets):
    jnet, params, tnet = v2_nets["swgan"]
    (img, lat), (want, want_lat) = _v2_case(
        jnet, params, tnet, "mix", np.random.default_rng(3))
    assert img.shape == (2, 64, 64, 3) and want.shape == img.shape
    _compare(lat, want_lat)
    _compare(img, want)


@pytest.mark.parametrize("case", ["mix", "wplus"])
def test_style_generator_matches_jax(generator, case):
    """Two styles at the default inject_index (n_latent // 2) with
    truncation and fresh noise; a W+ tensor with the fixed buffers."""
    jnet, params, tnet = generator
    rng = np.random.default_rng(21)
    b = 2
    if case == "mix":
        arrays = dict(
            styles=[rng.standard_normal((b, SD)).astype(np.float32)
                    for _ in range(2)],
            noise=_noise([n.shape for n in params["noises"]], b, rng),
            truncation_latent=rng.standard_normal((1, SD))
            .astype(np.float32))
        kw = dict(truncation=0.5)
    else:
        arrays = dict(styles=[rng.standard_normal(
            (b, jnet.n_latent, SD)).astype(np.float32)])
        kw = dict(input_is_latent=True, randomize_noise=False)
    (img, lat), (want, want_lat) = _both(
        lambda **a: jnet.apply(params, a.pop("styles"), **a),
        lambda **a: tnet(a.pop("styles"), **a), arrays,
        return_latents=True, **kw)
    assert img.shape == (2, 64, 64, 3)
    _compare(lat, want_lat)
    _compare(img, want)


@pytest.mark.parametrize("net,batch", [("b4", 4), ("c_dim", 4),
                                       ("b8", 8)])
def test_discriminator_matches_jax(discriminators, net, batch):
    """B = 4: one stddev group of 4; B = 8: two groups, whose order
    (sample b = g * m + j) the stddev channel must keep; c_dim = 10: the
    pose-projection head."""
    jnet, params, tnet = discriminators[net]
    rng = np.random.default_rng(batch)
    size, ch = DISC_KW[net]["size"], DISC_KW[net]["img_channel"]
    img = rng.standard_normal((batch, size, size, ch)).astype(np.float32)
    # samples of one stddev group differ in scale, so that a wrong grouping
    # moves the stddev channel
    img *= np.linspace(0.5, 2.0, batch, dtype=np.float32)[:, None, None,
                                                           None]
    arrays = dict(img=img)
    if jnet.c_dim:
        arrays["flat_pose"] = rng.standard_normal(
            (batch, jnet.c_dim)).astype(np.float32)
    got, want = _both(lambda **a: jax.jit(jnet.apply)(params, **a),
                      lambda **a: tnet(**a), arrays)
    assert got.shape == (batch, 1)
    _compare(got, want)


def _assert_round_trip(params, back):
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(_np_tree(back))[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


@pytest.mark.parametrize("model", ["base", "add_dwt", "wo_dwt", "c_dim",
                                   "swgan", "generator", "b4", "c_dim_d"])
def test_state_dict_round_trips_through_jax_importer(
        v2_nets, generator, discriminators, model):
    """The JAX package's torch-checkpoint importer of the port module's
    state_dict gives back, bit for bit, the JAX tree it was converted
    from; the port module's keys are exactly the converter's."""
    if model in v2_nets:
        (jnet, params, tnet), to_state = v2_nets[model], (
            convert.swgan_unet_state if model == "swgan"
            else convert.dual_styleunet_v2_state)
        importer = (jckpt.import_swgan_unet if model == "swgan"
                    else jckpt.import_dual_styleunet_v2)
    elif model == "generator":
        (jnet, params, tnet), to_state = generator, \
            convert.style_generator_state
        importer = jckpt.import_style_generator
    else:
        (jnet, params, tnet), to_state = discriminators[
            "c_dim" if model == "c_dim_d" else model], \
            convert.discriminator_state
        importer = jckpt.import_discriminator
    sd = {k: v.numpy() for k, v in tnet.state_dict().items()}
    assert sd.keys() == to_state(params).keys()
    _assert_round_trip(params, importer(sd, "", jnet))


def test_latent_utilities_and_device():
    """mean_latent, make_noise and the fixed-noise path on the port's own
    draws; a module with no device given lives on the card, so without
    one it raises."""
    gen = torch.Generator().manual_seed(0)
    net = tv2.DualStyleUNetV2(c_dim=4, device="cpu", generator=gen, **KW)
    with torch.no_grad():            # the noise weights start at zero
        for name, p in net.named_parameters():
            if name.endswith("noise.weight"):
                p.fill_(0.5)
    mean = net.mean_latent(16, torch.Generator().manual_seed(1))
    assert mean.shape == (1, SD)
    zeros = net.make_noise()
    drawn = net.make_noise(torch.Generator().manual_seed(2))
    assert [n.shape for n in zeros] == [n.shape for n in drawn] == [
        (1, r, r, 1) for r in (16, 16, 32, 32)]
    assert all(float(n.abs().max()) == 0 for n in zeros)
    assert all(float(n.abs().max()) > 0 for n in drawn)
    x = torch.randn(1, 64, 64, 3)
    w = net.get_latent(torch.randn(1, SD), torch.randn(1, 4))
    with torch.no_grad():
        _, lat = net([w], x, input_is_latent=True, truncation=0.0,
                     truncation_latent=mean, return_latents=True)
        buffers, _ = net([w], x, input_is_latent=True, randomize_noise=False)
        fresh, _ = net([w], x, input_is_latent=True,
                       generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(lat, mean[:, None].expand_as(lat))
    assert float((buffers - fresh).abs().max()) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsg.StyleGenerator(**GEN_KW)
