"""The port's novel-pose render slice end to end against the JAX package on
the CPU: AvatarNet.render and render_sequence with the JAX weights carried
across by params_from_jax, the pieces of the slice one by one, the
import_avatar_params round trip, and a subprocess check that the port
renders without importing jax."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.models import styleunet as jsu
from animatablegaussians_tpu.models.avatar import AvatarNet as JAvatarNet
from animatablegaussians_tpu.ops.rasterize import RasterizeConfig
from animatablegaussians_tpu.training.checkpoint import import_avatar_params
from animatablegaussians_tpu.utils import synthetic as jsyn
from animatablegaussians_torch.models.avatar import AvatarNet as TAvatarNet
from animatablegaussians_torch.utils.convert import params_from_jax

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

MAP_H, IMG = 64, 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _highest_precision():
    prev = jsu.CONV_PRECISION
    jsu.set_conv_precision("highest")
    yield
    jsu.set_conv_precision(prev)


def _params_np(params):
    p = dict(params)
    p["cano_gaussian"] = dataclasses.asdict(params["cano_gaussian"])
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def pair():
    pos, nml, lbs = jsyn.make_cano_map(map_h=MAP_H)
    opt = {"with_viewdirs": True, "channel_max": 32}
    # caps that cover the scene: JAX must drop nothing (n_overflow == 0)
    jnet = JAvatarNet(opt, pos, lbs, cano_nml_map=nml,
                      raster_config=RasterizeConfig(
                          backend="ref", k_max=1024, max_dup=64,
                          max_active_tiles=0))
    params = jnet.init(jax.random.PRNGKey(0))
    tnet = TAvatarNet(opt, pos, lbs, cano_nml_map=nml, device="cpu")
    tnet.load_state_dict(params_from_jax(_params_np(params)))
    items = jsyn.make_items(img_w=IMG, img_h=IMG, cano_pos_map=pos)
    keys = ("smpl_pos_map", "cano2live_jnt_mats", "extr", "intr")
    items = {k: items[k] for k in keys}
    return jnet, params, tnet, items


def _t(items):
    return {k: torch.as_tensor(v) for k, v in items.items()}


def _j(items):
    return {k: jnp.asarray(v) for k, v in items.items()}


# float32 CNN on both sides (JAX folds its resampling chains, so sums are
# ordered differently) feeding the splat: 2e-4 on images in [0, 1]
ATOL = 2e-4


def test_render_matches_jax(pair):
    jnet, params, tnet, items = pair
    bg = (0.3, 0.6, 0.9)
    want = jax.jit(lambda p, it: jnet.render(
        p, it, bg_color=bg, img_w=IMG, img_h=IMG))(params, _j(items))
    assert int(want["n_overflow"]) == 0
    got = tnet.render(_t(items), bg_color=bg, img_w=IMG, img_h=IMG)
    assert got["n_pairs"] == int(want["n_pairs"]) > 0
    for k in ("rgb_map", "mask_map", "depth_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)
    for k in ("offset", "pos_map", "cano_tex_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
    assert float(got["mask_map"].mean()) > 0.01


def test_render_sequence_matches_jax(pair):
    jnet, params, tnet, items = pair
    n_frames = 2
    seq = {k: np.broadcast_to(v, (n_frames,) + v.shape).copy()
           for k, v in items.items()}
    seq["extr"][1, :3, 3] += np.float32([0.02, -0.01, 0.03])
    seq["cano2live_jnt_mats"][1] = jsyn.make_items(
        img_w=IMG, img_h=IMG, seed=1)["cano2live_jnt_mats"]
    want = jax.jit(lambda p, it: jnet.render_sequence(
        p, it, bg_color=(1.0, 1.0, 1.0), img_w=IMG, img_h=IMG))(
            params, _j(seq))
    got = tnet.render_sequence(_t(seq), bg_color=(1.0, 1.0, 1.0), img_w=IMG,
                               img_h=IMG)
    for k in ("rgb_map", "mask_map", "depth_map"):
        assert got[k].shape[0] == n_frames
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)
    # each frame of the batched heads equals its own single-frame render
    one = tnet.render({k: v[1] for k, v in _t(seq).items()},
                      bg_color=(1.0, 1.0, 1.0), img_w=IMG, img_h=IMG)
    np.testing.assert_allclose(got["rgb_map"][1].numpy(),
                               one["rgb_map"].numpy(), atol=1e-5)


def test_viewdir_features_match_jax(pair):
    jnet, params, tnet, items = pair
    want_map = jnet._viewdir_half_map(_j(items))
    want = jnet._encode_viewdirs(params, want_map[None])
    with torch.no_grad():
        got_map = tnet._viewdir_half_map(_t(items))
        got = tnet._encode_viewdirs(got_map[None])
    np.testing.assert_allclose(got_map.numpy(), np.asarray(want_map),
                               atol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_transform_and_select_match_jax(pair):
    jnet, params, tnet, items = pair
    rng = np.random.default_rng(4)
    n = tnet.n_points
    vals = dict(positions=rng.standard_normal((n, 3)).astype(np.float32),
                rotations=rng.standard_normal((n, 4)).astype(np.float32))
    want = jnet.transform_cano2live({k: jnp.asarray(v) for k, v in
                                     vals.items()}, _j(items))
    got = tnet.transform_cano2live(_t(vals), _t(items))
    np.testing.assert_allclose(got["positions"].numpy(),
                               np.asarray(want["positions"]), atol=1e-5)
    # quaternion signs are canonicalized (w >= 0) on both sides
    np.testing.assert_allclose(got["rotations"].numpy(),
                               np.asarray(want["rotations"]), atol=1e-5)
    S = MAP_H
    outs = [rng.standard_normal((1, S, S, c)).astype(np.float32)
            for c in (6, 16, 6)]
    np.testing.assert_array_equal(
        tnet._select_masked_dual([torch.as_tensor(o) for o in outs]).numpy(),
        np.asarray(jnet._select_masked_dual([jnp.asarray(o) for o in outs])))


def test_state_dict_round_trips_through_import_avatar_params(pair):
    """import_avatar_params of the port's state_dict (as numpy) reproduces
    the JAX parameters exactly: params_from_jax is its inverse."""
    jnet, params, tnet, _ = pair
    sd = {k: v.detach().numpy() for k, v in tnet.state_dict().items()}
    back = import_avatar_params(sd, jnet, params)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_port_renders_without_jax():
    """Importing the port and rendering the fixture on the CPU loads no
    jax module."""
    code = (
        "import sys, torch\n"
        "from animatablegaussians_torch.tools import render_fixture as rf\n"
        "net, items = rf.build('cpu', map_h=64, img_w=48, img_h=64, "
        "channel_max=8)\n"
        "out = net.render_sequence(rf.sequence(items, 2), img_w=48, "
        "img_h=64)\n"
        "assert out['rgb_map'].shape == (2, 64, 48, 3)\n"
        "assert torch.isfinite(out['rgb_map']).all()\n"
        "mods = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'animatablegaussians_tpu'))]\n"
        "assert not mods, mods\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
