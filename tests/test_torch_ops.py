"""Port ops (quaternions, the upfirdn2d family, KNN, create_from_pcd and the
synthetic fixture) against the JAX package on the CPU, on the same numpy
inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from animatablegaussians_tpu.models import gaussian_model as jgm
from animatablegaussians_tpu.models import styleunet as jsu
from animatablegaussians_tpu.ops import knn as jknn
from animatablegaussians_tpu.ops import quat as jquat
from animatablegaussians_tpu.ops import upfirdn2d as jfir
from animatablegaussians_tpu.utils import synthetic as jsyn
from animatablegaussians_torch.models import gaussian_model as tgm
from animatablegaussians_torch.ops import knn as tknn
from animatablegaussians_torch.ops import quat as tquat
from animatablegaussians_torch.ops import upfirdn2d as tfir
from animatablegaussians_torch.utils import synthetic as tsyn

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def _highest_precision():
    """JAX's convs and FIR taps at full float32 for the whole test."""
    prev = jsu.CONV_PRECISION
    jsu.set_conv_precision("highest")
    yield
    jsu.set_conv_precision(prev)


def _quats(n=64, seed=0):
    q = np.random.default_rng(seed).standard_normal((n, 4)).astype(
        np.float32)
    q[0] = 0.0                       # zero-safe normalize
    q[1] = [0.0, 1.0, 0.0, 0.0]      # 180 degree turns: pivot != w
    q[2] = [0.0, 0.0, 0.0, 1.0]
    return q


def test_quat_normalize_and_to_mat():
    q = _quats()
    np.testing.assert_allclose(tquat.normalize(torch.as_tensor(q)).numpy(),
                               np.asarray(jquat.normalize(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-7)
    q = q[1:]
    np.testing.assert_allclose(tquat.quat_to_mat(torch.as_tensor(q)).numpy(),
                               np.asarray(jquat.quat_to_mat(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-6)


def test_mat_to_quat_matches_jax_as_rotations():
    """Quaternion signs are ambiguous: compare the rotations they make."""
    q = _quats(seed=1)[1:]
    m = np.array(jquat.quat_to_mat(jnp.asarray(q)))
    got = tquat.mat_to_quat(torch.as_tensor(m))
    want = jquat.mat_to_quat(jnp.asarray(m))
    np.testing.assert_allclose(
        tquat.quat_to_mat(got).numpy(),
        np.asarray(jquat.quat_to_mat(want)), atol=2e-6)
    np.testing.assert_allclose(tquat.quat_to_mat(got).numpy(), m, atol=2e-6)
    assert (got[:, 0] >= 0).all()


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, atol=1e-5):
    """The FIR chains are exact dyadic taps; 1e-5 covers float32 summation
    order on O(1) values (the JAX side folds some chains into one conv)."""
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


KER = tfir.make_kernel([1, 3, 3, 1])


@pytest.mark.parametrize("up,down,pad", [
    (1, 1, (1, 2)), (2, 1, (2, 1)), (1, 2, (1, 1)), (2, 2, (1, 2)),
    (1, 1, (-1, 2, 0, 1))])
def test_upfirdn2d_matches_jax(up, down, pad):
    x = _x((2, 10, 12, 3))
    _close(tfir.upfirdn2d(torch.as_tensor(x), KER, up, down, pad),
           jfir.upfirdn2d(jnp.asarray(x), KER, up, down, pad))


@pytest.mark.parametrize("c", [3, 80])   # JAX: polyphase (c<=64) and plain
def test_resample_family_matches_jax(c):
    x = _x((1, 8, 8, c), seed=c)
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    _close(tfir.upsample(tx, KER), jfir.upsample(jx, KER))
    _close(tfir.downsample(tx, KER), jfir.downsample(jx, KER))
    _close(tfir.blur(tx, KER, (2, 1)), jfir.blur(jx, KER, (2, 1)))
    _close(tfir.blur(tx, KER, (1, 1), upsample_factor=2),
           jfir.blur(jx, KER, (1, 1), upsample_factor=2))


def test_fused_leaky_relu_matches_jax():
    x, b = _x((2, 5, 5, 6)), _x((6,), seed=1)
    _close(tfir.fused_leaky_relu(torch.as_tensor(x), torch.as_tensor(b)),
           jfir.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b)), atol=1e-6)


@pytest.mark.parametrize("c", [3, 8])
def test_wavelets_and_space_depth_match_jax(c):
    x = _x((2, 8, 10, 4 * c), seed=c)
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    _close(tfir.haar_transform(tx), jfir.haar_transform(jx))
    _close(tfir.inverse_haar_transform(tx), jfir.inverse_haar_transform(jx))
    _close(tfir.wavelet_upsample(tx), jfir.wavelet_upsample(jx))
    _close(tfir.wavelet_downsample(tx), jfir.wavelet_downsample(jx))
    np.testing.assert_array_equal(tfir.depth_to_space2(tx).numpy(),
                                  np.asarray(jfir.depth_to_space2(jx)))
    np.testing.assert_array_equal(tfir.space_to_depth2(tx).numpy(),
                                  np.asarray(jfir.space_to_depth2(jx)))
    # inverse pairs
    np.testing.assert_allclose(
        tfir.inverse_haar_transform(tfir.haar_transform(tx)).numpy(), x,
        atol=1e-5)


def _cloud(n=300, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(
        np.float32)


def test_knn_matches_jax():
    pts = _cloud()
    d_t, i_t = tknn.knn(torch.as_tensor(pts), torch.as_tensor(pts), k=4,
                        chunk=64)
    d_j, i_j = jknn.knn(jnp.asarray(pts), jnp.asarray(pts), k=4)
    # same |q|^2+|r|^2-2q.r expansion in float32; a few ulps of the norms
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=2e-6)
    np.testing.assert_array_equal(i_t[:, 1:].numpy(), np.asarray(i_j)[:, 1:])


def test_create_from_pcd_matches_jax():
    pts = _cloud(seed=1)
    colors = np.random.default_rng(2).random((300, 3)).astype(np.float32)
    want = jgm.create_from_pcd(jnp.asarray(pts), jnp.asarray(colors))
    got = tgm.create_from_pcd(torch.as_tensor(pts), torch.as_tensor(colors))
    for f in tgm.GaussianParams.FIELDS:
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


def test_synthetic_fixture_equals_jax_package():
    """The port's numpy copy of the fixture builders is the JAX package's."""
    for a, b in zip(tsyn.make_cano_map(32), jsyn.make_cano_map(32)):
        np.testing.assert_array_equal(a, b)
    pos = jsyn.make_cano_map(32)[0]
    ta = tsyn.make_items(img_w=40, img_h=24, seed=3, cano_pos_map=pos)
    ja = jsyn.make_items(img_w=40, img_h=24, seed=3, cano_pos_map=pos)
    assert ta.keys() == ja.keys()
    for k in ta:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
