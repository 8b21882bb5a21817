"""The port's novel-pose render slice end to end against the JAX package on
the CPU: AvatarNet.render and render_sequence with the JAX weights carried
across by params_from_jax, the pieces of the slice one by one, the mean-hand
render and the pose-map regeneration, the import_avatar_params round trip,
the model keys ``weight_viewdirs`` and ``texel_block`` (``remat`` and
``random_style`` are held in tests/test_torch_remat.py), and a subprocess
check that the port renders without importing jax.

Marked ``gpu`` (skipped without a CUDA device), on the full-width
fixture: generate_mean_hands and a render with the mean hands blended in
through the kernels against ``plain=True``, and a render from the pose map
get_pose_map regenerates, with the points the mean hands move."""

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
from animatablegaussians_tpu.models.gaussian_model import GaussianParams
from animatablegaussians_tpu.ops.rasterize import RasterizeConfig
from animatablegaussians_tpu.training.checkpoint import import_avatar_params
from animatablegaussians_tpu.utils import synthetic as jsyn
from animatablegaussians_torch.models.avatar import AvatarNet as TAvatarNet
from animatablegaussians_torch.tools.render_fixture import (
    hand_items, zero_head_outputs)
from animatablegaussians_torch.utils.convert import params_from_jax
from on_card import (ATOL_FIR_IMG, card, compare_images, fir_count,  # noqa
                     full_width, launches, reset_launches, train_kw)

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


def _raster(k_max=1024):
    # caps that cover the scene: JAX must drop nothing (n_overflow == 0)
    return RasterizeConfig(backend="ref", k_max=k_max, max_dup=64,
                           max_active_tiles=0)


def _nets(opt, pos, nml, lbs):
    """The JAX AvatarNet, its params and the port's with them carried
    across, for one model config."""
    jnet = JAvatarNet(opt, pos, lbs, cano_nml_map=nml, raster_config=_raster())
    params = jnet.init(jax.random.PRNGKey(0))
    tnet = TAvatarNet(opt, pos, lbs, cano_nml_map=nml, device="cpu")
    tnet.load_state_dict(params_from_jax(_params_np(params)))
    return jnet, params, tnet


def _nets_from_port(opt, pos, nml, lbs, k_max=1024, zero_heads=False):
    """As ``_nets``, but the port draws the weights (``zero_heads``: the
    position and other heads' ToRGB weights zeroed, as in the full-width
    fixture) and the JAX package's ``import_avatar_params``, the inverse of
    ``params_from_jax``, carries them across: the JAX initializer is slow
    on the CPU."""
    tnet = TAvatarNet(opt, pos, lbs, cano_nml_map=nml, device="cpu")
    if zero_heads:
        zero_head_outputs(tnet)
    jnet = JAvatarNet(opt, pos, lbs, cano_nml_map=nml,
                      raster_config=_raster(k_max))
    sd = {k: v.numpy() for k, v in tnet.state_dict().items()}
    params = import_avatar_params(sd, jnet, {"cano_gaussian": GaussianParams(
        **{f: jnp.asarray(sd[f"cano_gaussian.{f}"])
           for f in tnet.cano_gaussian.FIELDS})})
    return jnet, params, tnet


@pytest.fixture(scope="module")
def pair():
    pos, nml, lbs = jsyn.make_cano_map(map_h=MAP_H)
    jnet, params, tnet = _nets({"with_viewdirs": True, "channel_max": 32},
                               pos, nml, lbs)
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


@pytest.fixture(scope="module")
def hands(pair):
    """The pair's items plus the mean-hand items (render_fixture's MANO
    stand-ins, 100 points a hand at this size) and a second pose's
    woRoot joint mats, and the mean hands both packages generate from the
    pose map that JAX regenerates for that pose."""
    jnet, params, tnet, items = pair
    pos, _, _ = jsyn.make_cano_map(map_h=MAP_H)
    items = dict(items, **hand_items(pos, n_verts=100))
    items["cano2live_jnt_mats_woRoot"] = jsyn.make_items(
        img_w=IMG, img_h=IMG, seed=1)["cano2live_jnt_mats_woRoot"]
    pose_map = np.array(jnet.get_pose_map(_j(items)))
    want = jnet.generate_mean_hands(params, jnp.asarray(pose_map[..., :3]))
    got = tnet.generate_mean_hands(torch.as_tensor(pose_map[..., :3]))
    return items, pose_map, want, got


def test_get_pose_map_matches_jax(pair, hands):
    """The canonical points skinned by the woRoot joints and scattered to
    the half-res (S, S, 6) map."""
    _, _, tnet, _ = pair
    items, want, _, _ = hands
    got = tnet.get_pose_map(_t(items))
    assert got.shape == (MAP_H // 2, MAP_H // 2, 6) == want.shape
    # one (N, J) x (J, 16) product and a 3x3 transform, float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert np.abs(want).max() > 0.1


def test_generate_mean_hands_matches_jax(pair, hands):
    jnet, _, tnet, _ = pair
    _, _, want, got = hands
    assert got.keys() == want.keys()
    for k in got:
        # three float32 heads (the JAX side's resampling folded), then the
        # activations: as test_render_matches_jax's head outputs
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)


def test_render_with_mean_hands_matches_jax(pair, hands):
    """render(hand_vals=...) against the JAX render: the blend moves the
    points near the two hand boxes, and the image with it differs from the
    one without."""
    jnet, params, tnet, _ = pair
    items, _, jhands, thands = hands
    bg = (0.3, 0.6, 0.9)
    want = jax.jit(lambda p, it, hv: jnet.render(
        p, it, bg_color=bg, img_w=IMG, img_h=IMG, hand_vals=hv))(
            params, _j(items), jhands)
    got = tnet.render(_t(items), bg_color=bg, img_w=IMG, img_h=IMG,
                      hand_vals=thands)
    plain = tnet.render(_t(items), bg_color=bg, img_w=IMG, img_h=IMG)
    for k in ("rgb_map", "mask_map", "depth_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)
    for k in ("positions", "opacity", "scales", "rotations"):
        np.testing.assert_allclose(got["posed_gaussians"][k].numpy(),
                                   np.asarray(want["posed_gaussians"][k]),
                                   atol=1e-5, err_msg=k)
    moved = (got["posed_gaussians"]["positions"]
             - plain["posed_gaussians"]["positions"]).abs().amax(1) > 1e-6
    assert 0 < int(moved.sum()) < tnet.n_points
    assert float((got["rgb_map"] - plain["rgb_map"]).abs().max()) > 1e-3


def test_render_sequence_with_mean_hands_and_pca_matches_jax(pair, hands):
    """render_sequence with hand_vals, reading the pose maps under the
    use_pca key."""
    jnet, params, tnet, _ = pair
    items, _, jhands, thands = hands
    seq = {k: np.broadcast_to(v, (2,) + np.shape(v)).copy()
           for k, v in items.items()}
    seq["smpl_pos_map_pca"] = seq.pop("smpl_pos_map")
    seq["extr"][1, :3, 3] += np.float32([0.02, -0.01, 0.03])
    want = jax.jit(lambda p, it, hv: jnet.render_sequence(
        p, it, img_w=IMG, img_h=IMG, use_pca=True, hand_vals=hv))(
            params, _j(seq), jhands)
    got = tnet.render_sequence(_t(seq), img_w=IMG, img_h=IMG, use_pca=True,
                               hand_vals=thands)
    for k in ("rgb_map", "mask_map", "depth_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)


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


def _render_pair(jnet, params, tnet, items, img):
    bg = (0.3, 0.6, 0.9)
    want = jax.jit(lambda p, it: jnet.render(
        p, it, bg_color=bg, img_w=img, img_h=img))(params, _j(items))
    assert int(want["n_overflow"]) == 0
    got = tnet.render(_t(items), bg_color=bg, img_w=img, img_h=img)
    assert got["n_pairs"] == int(want["n_pairs"]) > 0
    return got, want


def test_weight_viewdirs_matches_jax():
    """``weight_viewdirs`` scales both view features. They reach the image
    only at out_size 1024 (a 1024x2048 canonical map), so the map keeps
    two rows of one half of the synthetic body, front and back (about two
    thousand texels: the KNN and the splat stay small, no pixel reaches the
    transmittance cutoff and no two Gaussians sit at mirrored equal
    depths). The heads are as narrow as the 128-channel view features
    allow, with the position and other heads zeroed as in the full-width
    fixture (``_nets_from_port``)."""
    pos, nml, lbs = jsyn.make_cano_map(map_h=1024)
    mask = np.linalg.norm(pos, axis=-1) > 0
    band = np.zeros_like(mask)
    band[510:512, 512:1024] = band[510:512, 1536:] = True
    lbs = lbs[band[mask]]
    pos, nml = pos * band[..., None], nml * band[..., None]
    opt = {"with_viewdirs": True, "channel_max": 128,
           "weight_viewdirs": 0.5}
    jnet, params, tnet = _nets_from_port(opt, pos, nml, lbs, k_max=8192,
                                         zero_heads=True)
    items = jsyn.make_items(img_w=IMG, img_h=IMG, cano_pos_map=pos)
    items = {k: items[k] for k in ("smpl_pos_map", "cano2live_jnt_mats",
                                   "extr", "intr")}
    got, want = _render_pair(jnet, params, tnet, items, IMG)
    for k in ("rgb_map", "mask_map", "depth_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)
    # colours to the CNN's float32 rounding, as test_render_matches_jax
    np.testing.assert_allclose(got["cano_tex_map"].numpy(),
                               np.asarray(want["cano_tex_map"]), atol=1e-5)
    # the key is read: both features scale with it
    with torch.no_grad():
        vmap = tnet._viewdir_half_map(_t(items))[None]
        half = tnet._encode_viewdirs(vmap)
        tnet.weight_viewdirs = 1.0
        full = tnet._encode_viewdirs(vmap)
    for h, f in zip(half, full):
        assert float(f.abs().max()) > 0
        torch.testing.assert_close(2.0 * h, f, rtol=0, atol=0)


@pytest.mark.parametrize("texel_block", [1, 4])
def test_texel_block_matches_jax(pair, texel_block):
    """The point set's block packing follows ``texel_block``: the same
    points as JAX's, the same masked select and half-res scatter (the odd
    block through the full-res scatter), and the same render."""
    _, _, _, items = pair
    pos, nml, lbs = jsyn.make_cano_map(map_h=MAP_H)
    opt = {"with_viewdirs": True, "channel_max": 32,
           "texel_block": texel_block}
    jnet, params, tnet = _nets_from_port(opt, pos, nml, lbs)
    assert tnet.n_points == jnet.n_points
    assert tnet.n_points < TAvatarNet({"channel_max": 8}, pos, lbs,
                                      cano_nml_map=nml, device="cpu").n_points
    rng = np.random.default_rng(texel_block)
    vals = rng.standard_normal((tnet.n_points, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tnet._scatter_masked_half(torch.as_tensor(vals), 3).numpy(),
        np.asarray(jnet._scatter_masked_half(jnp.asarray(vals), 3)))
    outs = [rng.standard_normal((1, MAP_H, MAP_H, c)).astype(np.float32)
            for c in (6, 16)]
    np.testing.assert_array_equal(
        tnet._select_masked_dual([torch.as_tensor(o) for o in outs]).numpy(),
        np.asarray(jnet._select_masked_dual([jnp.asarray(o) for o in outs])))
    got, want = _render_pair(jnet, params, tnet, items, IMG)
    for k in ("rgb_map", "mask_map", "depth_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)


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


# ---------------------------------------------------------------------------
# on the card, at full width
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_mean_hands_through_the_kernels_at_full_width(full_width, train_kw):
    """The mean hands come from weights three train steps moved (at the
    fixture's, the position and other heads output 0 for any pose map,
    and the hands would equal every frame's own Gaussians); the renders
    then run at the fixture's weights with those hands blended in."""
    from animatablegaussians_torch.ops import fir
    from animatablegaussians_torch.tools import render_fixture as rf
    from animatablegaussians_torch.training import avatar_trainer as at
    net, items, fixture = full_width
    net.load_state_dict(fixture)
    state = at.make_train_state(net, rf.LR_INIT, rf.ITER_NUM)
    step = at.make_train_step(net, **train_kw)
    gen = torch.Generator(device=items["extr"].device).manual_seed(13)
    for _ in range(3):
        state, _ = step(state, items, at.make_draws(gen, net.n_points))
    del state, step
    n_fir = fir_count(net)[0]
    hitems = {k: items[k] for k in rf.RENDER_KEYS + rf.HAND_KEYS}
    pose = hitems["smpl_pos_map"][..., :3]
    reset_launches(fir.upfirdn2d_fir)
    hands = net.generate_mean_hands(pose)
    assert launches(fir.upfirdn2d_fir)["upfirdn2d_fir"] == n_fir
    hands_p = net.generate_mean_hands(pose, plain=True)
    err = max(float((hands[k] - hands_p[k]).abs().max()) for k in hands)
    assert err <= ATOL_FIR_IMG, err

    net.load_state_dict(fixture)
    kw = dict(bg_color=(1.0, 1.0, 1.0), img_w=rf.IMG_W, img_h=rf.IMG_H)
    reset_launches(fir.upfirdn2d_fir)
    h_kern = net.render(hitems, hand_vals=hands, **kw)
    assert launches(fir.upfirdn2d_fir)["upfirdn2d_fir"] == n_fir
    h_plain = net.render(hitems, hand_vals=hands, plain=True, **kw)
    print(compare_images(h_kern, h_plain, ATOL_FIR_IMG))
    w = net.hand_weights(hitems)
    print(f"blend weight > 1e-3 at {int((w > 1e-3).sum())} points, > 0.5 "
          f"at {int((w > 0.5).sum())} of {net.n_points}")
    del h_kern, h_plain

    novel = dict(hitems, smpl_pos_map=net.get_pose_map(hitems))
    n_hand = net.render(novel, hand_vals=hands, **kw)
    n_bare = net.render(novel, **kw)
    moved = (n_hand["posed_gaussians"]["positions"]
             - n_bare["posed_gaussians"]["positions"]).norm(dim=1) > 1e-6
    assert float((n_hand["mask_map"] > 0.5).float().mean()) > 0
    assert int(moved.sum()) > 0
    for k in ("rgb_map", "mask_map", "depth_map"):
        assert torch.isfinite(n_hand[k]).all(), k
