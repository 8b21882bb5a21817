"""Port DualStyleUNet against the JAX package on the CPU: weights built by
the JAX net and carried across with convert.dual_styleunet_state, outputs
compared on the same numpy inputs, and the state_dict round trip through
the JAX package's torch-checkpoint importer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.models import styleunet as jsu
from animatablegaussians_tpu.training.checkpoint import import_dual_styleunet
from animatablegaussians_torch.models import styleunet as tsu
from animatablegaussians_torch.utils.convert import dual_styleunet_state

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def _highest_precision():
    prev = jsu.CONV_PRECISION
    jsu.set_conv_precision("highest")
    yield
    jsu.set_conv_precision(prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(inp, out, channel_max, style_dim=32, out_ch=3, seed=0):
    kw = dict(inp_size=inp, inp_ch=3, out_ch=out_ch, out_size=out,
              style_dim=style_dim, n_mlp=2, channel_max=channel_max)
    jnet = jsu.DualStyleUNet(**kw)
    params = jnet.init(jax.random.PRNGKey(seed))
    # random (not zero) noise weights and biases so every term is exercised
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    leaves = [l + 0.1 * jax.random.normal(k, l.shape) if l.ndim <= 1 else l
              for l, k in zip(leaves, keys)]
    params = _np_tree(jax.tree_util.tree_unflatten(treedef, leaves))
    tnet = tsu.DualStyleUNet(**kw)
    tnet.load_state_dict(dual_styleunet_state(params))
    return jnet, params, tnet


def _compare(got, want):
    """fp32 on both sides; the JAX side folds the resampling chains into
    polyphase convs, so outputs agree to summation order: rtol 1e-4 of the
    output's scale."""
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale)


@pytest.fixture(scope="module")
def small():
    return _pair(64, 128, 32)


@pytest.mark.parametrize("batch,style_rows", [(1, 1), (2, 1), (2, 2)])
def test_dual_styleunet_matches_jax(small, batch, style_rows):
    """One style row (the shared-weight branch) and per-sample styles."""
    jnet, params, tnet = small
    rng = np.random.default_rng(batch * 10 + style_rows)
    x = rng.standard_normal((batch, 64, 64, 3)).astype(np.float32)
    style = rng.standard_normal((style_rows, 32)).astype(np.float32)
    want = jnet.apply(params, jnp.asarray(style), jnp.asarray(x))
    with torch.no_grad():
        got = tnet(torch.as_tensor(style), torch.as_tensor(x))
    assert got.shape == (batch, 128, 128, 6)
    _compare(got, want)


def test_viewdir_injection_matches_jax():
    """The view features are added after decoder stage i == 8 (256^2), so
    they change the output only when a stage follows it: out_size 1024, as
    in the full-width heads. A narrow net with a small input keeps it
    cheap."""
    jnet, params, tnet = _pair(64, 1024, 8, style_dim=16, seed=3)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    style = np.ones((1, 16), np.float32) / 4.0
    vf1 = rng.standard_normal((1, 32, 32, 8)).astype(np.float32)
    vf2 = rng.standard_normal((1, 32, 32, 8)).astype(np.float32)
    want = jnet.apply(params, jnp.asarray(style), jnp.asarray(x),
                      view_feature1=jnp.asarray(vf1),
                      view_feature2=jnp.asarray(vf2))
    plain = jnet.apply(params, jnp.asarray(style), jnp.asarray(x))
    assert not np.allclose(np.asarray(want), np.asarray(plain))
    with torch.no_grad():
        got = tnet(torch.as_tensor(style), torch.as_tensor(x),
                   view_feature1=torch.as_tensor(vf1),
                   view_feature2=torch.as_tensor(vf2))
    _compare(got, want)


def test_state_dict_round_trips_through_jax_importer(small):
    """import_dual_styleunet (the JAX package's torch-checkpoint reader)
    of the port's state_dict reproduces the JAX params exactly, and the
    port module's keys and shapes are exactly the converted ones."""
    jnet, params, tnet = small
    sd = {k: v.numpy() for k, v in tnet.state_dict().items()}
    assert sd.keys() == dual_styleunet_state(params).keys()
    back = _np_tree(import_dual_styleunet(sd, "", jnet))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
