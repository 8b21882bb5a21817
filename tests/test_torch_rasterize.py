"""Port rasterizer (animatablegaussians_torch.ops.rasterize) against the JAX
package on the CPU: preprocess, binning pair order, the plain blend against
blend_tiles_ref and against the Pallas ragged blend in interpret mode, and
api.render end to end. The CUDA kernels themselves run only on the GPU
(chip_smoke.py compares them with these plain versions there)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from animatablegaussians_tpu.ops.rasterize import RasterizeConfig
from animatablegaussians_tpu.ops.rasterize import api as japi
from animatablegaussians_tpu.ops.rasterize import binning as jbin
from animatablegaussians_tpu.ops.rasterize.blend_ref import blend_tiles_ref
from animatablegaussians_tpu.ops.rasterize.preprocess import \
    preprocess as jpreprocess
from animatablegaussians_torch.ops.rasterize import api as tapi
from animatablegaussians_torch.ops.rasterize import binning as tbin
from animatablegaussians_torch.ops.rasterize import blend as tblend
from animatablegaussians_torch.ops.rasterize import expand as texpand
from animatablegaussians_torch.ops.rasterize.preprocess import \
    preprocess as tpreprocess

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

W, H = 64, 48
TILE = 16
GX, GY = -(-W // TILE), -(-H // TILE)


def make_scene(n=60, seed=0, n_pad=0, w=W, h=H):
    rng = np.random.default_rng(seed)
    means = rng.uniform([-0.8, -0.6, 2.0], [0.8, 0.6, 4.0],
                        (n, 3)).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.2, 0.9, (n,)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    extr = np.eye(4, dtype=np.float32)
    intr = np.array([[60.0, 0, w / 2], [0, 60.0, h / 2], [0, 0, 1]],
                    np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, n_pad, replace=False)] = False
    return dict(means=means, scales=scales, q=q, opac=opac, colors=colors,
                extr=extr, intr=intr, valid=valid, w=w, h=h)


def _pre_args(s, mod):
    """Arguments of preprocess for the JAX (mod=japi) or port side."""
    w, h = s["w"], s["h"]
    if mod is japi:
        vm, pm = japi._full_projection_traced(jnp.asarray(s["extr"]),
                                              jnp.asarray(s["intr"]), w, h)
        conv = jnp.asarray
    else:
        vm, pm = tapi._full_projection(torch.as_tensor(s["extr"]),
                                       torch.as_tensor(s["intr"]), w, h)
        conv = torch.as_tensor
    fx, fy = float(s["intr"][0, 0]), float(s["intr"][1, 1])
    return (conv(s["means"]), conv(s["scales"]), conv(s["q"]), vm, pm,
            w / (2 * fx), h / (2 * fy), w, h)


@pytest.mark.parametrize("seed", [0, 4])
def test_preprocess_matches_jax(seed):
    s = make_scene(n=200, seed=seed)
    s["means"][:5, 2] = 0.1  # behind the near plane: culled
    want = jpreprocess(*_pre_args(s, japi))
    got = tpreprocess(*_pre_args(s, tapi))
    # float32 component arithmetic in the same order: agreement to a few
    # ulps; radii come from ceil() and must be equal
    for f in ("means2d", "depths", "conics"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert not got.valid[:5].any()


def _random_bins_inputs(seed, n=500):
    rng = np.random.RandomState(seed)
    means2d = rng.uniform(-10, 140, (n, 2)).astype(np.float32)
    # duplicated depths exercise the tie-break path
    depths = rng.choice(np.linspace(0.5, 5.0, 40), n).astype(np.float32)
    radii = rng.randint(0, 30, (n,)).astype(np.int32)
    valid = rng.rand(n) > 0.2
    return means2d, depths, radii, valid


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_binning_pair_order_equals_jax(seed):
    """The port's expand + stable sort + ranges (plain expansion on the CPU)
    reproduce the JAX (tile, depth) pair list exactly, ties included."""
    means2d, depths, radii, valid = _random_bins_inputs(seed)
    img_w, img_h = 128, 96
    gx, gy = -(-img_w // TILE), -(-img_h // TILE)
    res = jbin._expand_pairs(jnp.asarray(means2d), jnp.asarray(depths),
                             jnp.asarray(radii), jnp.asarray(valid), gx, gy,
                             TILE, max_dup=gx * gy, max_pairs=16384)
    s_key, s_gid, starts, _, overflow, n_pairs, _ = res
    assert int(overflow) == 0
    bins = tbin.bin_gaussians(torch.as_tensor(means2d),
                              torch.as_tensor(depths),
                              torch.as_tensor(radii), torch.as_tensor(valid),
                              img_w, img_h, TILE)
    total = int(n_pairs)
    assert bins.n_pairs == total
    np.testing.assert_array_equal(bins.gid.numpy(), np.asarray(s_gid)[:total])
    np.testing.assert_array_equal(bins.starts.numpy(), np.asarray(starts))
    # ties did occur: some tile holds two pairs of equal depth
    tile_of = np.asarray(s_key)[:total]
    dep = depths[bins.gid.numpy()]
    assert np.any((np.diff(tile_of) == 0) & (np.diff(dep) == 0))


def test_expand_plain_slots():
    """Each Gaussian owns slots [offs[i], offs[i+1]) in ascending gid
    order, keys (tile << 32 | depth bits), row-major over its rect."""
    rect = torch.tensor([[1, 0, 2, 4], [0, 0, 3, 0], [2, 1, 1, 2]],
                        dtype=torch.int32)
    depth = torch.tensor([1.5, 2.0, 0.25])
    offs = torch.tensor([0, 4, 4, 6])
    keys, gids = texpand.expand_pairs(rect, depth, offs, 6, grid_x=5)
    bits = lambda d: int(np.float32(d).view(np.int32))
    tiles = [1, 2, 6, 7, 7, 12]
    ds = [1.5] * 4 + [0.25] * 2
    assert keys.tolist() == [(t << 32) | bits(d) for t, d in zip(tiles, ds)]
    assert gids.tolist() == [0, 0, 0, 0, 2, 2]


def test_wrappers_refuse_other_devices():
    """Neither wrapper falls back: a tensor neither on the CPU nor on a
    CUDA device is refused."""
    m = torch.empty((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        texpand.expand_pairs(m, torch.empty(2, device="meta"),
                             torch.empty(3, dtype=torch.int64, device="meta"),
                             0, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tblend.blend_tiles(torch.empty((2, 10), device="meta"), None, None,
                           1, 1, 16, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        tblend.blend_backward(torch.empty((2, 10), device="meta"), None,
                              None, 1, 1, 16, 16, *[None] * 6)


def _port_bins(s):
    pre = tpreprocess(*_pre_args(s, tapi))
    rows = tapi._pack_rows(pre, torch.as_tensor(s["opac"]),
                           torch.as_tensor(s["colors"]))
    bins = tbin.bin_gaussians(pre.means2d, pre.depths, pre.radii, pre.valid,
                              s["w"], s["h"], TILE)
    return rows, bins


def _images(out_t):
    """JAX (T, P, 8) tile output -> (H, W, 8)."""
    img = np.asarray(out_t).reshape(GY, GX, TILE, TILE, 8)
    return img.transpose(0, 2, 1, 3, 4).reshape(GY * TILE, GX * TILE, 8)[
        :H, :W]


def _compare_blend(got, want_img, atol):
    color, depth, t_fin = got
    np.testing.assert_allclose(color.numpy(), want_img[..., :3], atol=atol)
    np.testing.assert_allclose(depth.numpy(), want_img[..., 3], atol=atol)
    np.testing.assert_allclose(t_fin.numpy(), want_img[..., 4], atol=atol)


def test_plain_blend_matches_blend_tiles_ref():
    s = make_scene(n=150, seed=2)
    rows, bins = _port_bins(s)
    counts = (bins.starts[1:] - bins.starts[:-1]).numpy()
    K = int(-(-counts.max() // 128) * 128)
    rows_np = np.concatenate([rows.numpy(), np.zeros((1, 10), np.float32)])
    idx = np.full((GX * GY, K), rows.shape[0])
    for t in range(GX * GY):
        a, b = int(bins.starts[t]), int(bins.starts[t + 1])
        idx[t, :b - a] = bins.gid[a:b].numpy()
    tile_data = np.zeros((GX * GY, 16, K), np.float32)
    tile_data[:, :10] = rows_np[idx].transpose(0, 2, 1)
    want = blend_tiles_ref(jnp.asarray(tile_data), jnp.asarray(counts), GX,
                           TILE)
    got = tblend.blend_tiles(rows, bins.gid, bins.starts, GX, GY, W, H)
    # the same cumulative-product formula in float32; only the order of the
    # colour sums differs
    _compare_blend(got, _images(want), atol=1e-5)


def _chunk_layout(rows, bins, n_tiles, kb=128):
    """The port's tile ranges as blend_chunks' ragged input: (C, 16, kb)
    chunk data, per-chunk pair count, tile id and first-chunk flag, and the
    (C, kb) gids of each chunk's slots (N past a chunk's pairs)."""
    counts = (bins.starts[1:] - bins.starts[:-1]).numpy()
    n_rows = rows.shape[0]
    rows_np = np.concatenate([rows.detach().numpy(),
                              np.zeros((1, 10), np.float32)])
    data, n, tid, first, gids = [], [], [], [], []
    for t in range(n_tiles):
        a = int(bins.starts[t])
        for c in range(-(-int(counts[t]) // kb)):
            m = min(kb, int(counts[t]) - c * kb)
            ids = np.full(kb, n_rows)
            ids[:m] = bins.gid[a + c * kb:a + c * kb + m].numpy()
            blk = np.zeros((16, kb), np.float32)
            blk[:10] = rows_np[ids].T
            data.append(blk)
            n.append(m)
            tid.append(t)
            first.append(int(c == 0))
            gids.append(ids)
    i32 = lambda v: jnp.asarray(np.asarray(v, np.int32))
    return (jnp.asarray(np.stack(data)), i32(n), i32(tid), i32(first),
            np.stack(gids))


def test_plain_blend_matches_ragged_pallas_interpret():
    """Against blend_chunks (the _fwd_chunk_kernel path) in interpret mode,
    on a scene dense enough that tiles span several 128-pair chunks, so the
    cross-chunk carry is exercised."""
    from animatablegaussians_tpu.ops.rasterize.blend_pallas import \
        blend_chunks
    s = make_scene(n=400, seed=7)
    rows, bins = _port_bins(s)
    counts = (bins.starts[1:] - bins.starts[:-1]).numpy()
    assert counts.max() > 128
    data, n, tid, first, _ = _chunk_layout(rows, bins, GX * GY)
    out = blend_chunks(data, n, tid, first, tid, GX * GY, GX, TILE)
    out = np.where((counts > 0)[:, None, None], np.asarray(out),
                   np.array([0, 0, 0, 0, 1, 0, 0, 0], np.float32))
    got = tblend.blend_tiles(rows, bins.gid, bins.starts, GX, GY, W, H)
    # the TPU kernel's log-step scans round differently from cumprod
    _compare_blend(got, _images(out), atol=1e-5)


@pytest.mark.parametrize("seed,n_pad", [(0, 0), (5, 30)])
def test_render_matches_jax(seed, n_pad):
    """api.render against JAX api.render(backend="ref") on all seven
    outputs; pad points (valid_mask False) are never binned."""
    s = make_scene(n=150, seed=seed, n_pad=n_pad)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = japi.render(
        jnp.asarray(s["means"]), jnp.asarray(s["scales"]),
        jnp.asarray(s["q"]), jnp.asarray(s["opac"]),
        jnp.asarray(s["colors"]), jnp.asarray(bg), jnp.asarray(s["extr"]),
        jnp.asarray(s["intr"]), W, H,
        config=RasterizeConfig(backend="ref", k_max=512, max_dup=16),
        valid_mask=jnp.asarray(s["valid"]))
    assert int(want["n_overflow"]) == 0
    t = lambda k: torch.as_tensor(s[k])
    got = tapi.render(t("means"), t("scales"), t("q"), t("opac"),
                      t("colors"), torch.as_tensor(bg), t("extr"), t("intr"),
                      W, H, valid_mask=t("valid"))
    for k in ("render", "depth", "mask"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["means2d"].numpy(),
                               np.asarray(want["means2d"]), rtol=1e-6,
                               atol=1e-5)
    for k in ("radii", "visibility_filter"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["n_pairs"] == int(want["n_pairs"])
    assert not got["visibility_filter"][~s["valid"]].any()


def _kdtree_knn(query, ref, k=4, **_):
    """Exact k nearest neighbours by a k-d tree: squared distances (Q, k)
    float32 and indices (Q, k) int32, ascending, the point itself first."""
    from scipy.spatial import cKDTree
    q = np.asarray(query, np.float64)
    d, i = cKDTree(np.asarray(ref, np.float64)).query(q, k=k)
    return (d ** 2).astype(np.float32), i.astype(np.int32)


def test_full_fixture_pair_count_matches_jax(monkeypatch):
    """At full width (the chip_smoke.py fixture: 531,520 block-packed
    Gaussians with create_from_pcd attributes, skinned, 1500x2048) the
    port's pair count equals the JAX package's, and both equal the
    reference chip_smoke.py holds the GPU run to. Each side is its own
    package's code end to end: the JAX package's synthetic fixture,
    AvatarNet (block-packed point set, create_from_pcd, transform_cano2live
    with its ops/quat), preprocess and tile_rect, against the port's. Only
    the KNN is substituted, on both sides: exact distances from a k-d tree
    stand in for the brute-force KNN, too slow on the CPU at this size; its
    float32 expansion moves the count by ~0.02%."""
    import chip_smoke

    from animatablegaussians_tpu.models import gaussian_model as jgm
    from animatablegaussians_tpu.models.avatar import AvatarNet as JNet
    from animatablegaussians_tpu.utils import synthetic
    from animatablegaussians_torch.models import gaussian_model as tgm
    from animatablegaussians_torch.models.avatar import AvatarNet as TNet

    monkeypatch.setattr(jgm, "knn", lambda q, r, k=4: tuple(
        jnp.asarray(a) for a in _kdtree_knn(q, r, k)))
    monkeypatch.setattr(tgm, "knn", lambda q, r, k=4: tuple(
        torch.as_tensor(a) for a in _kdtree_knn(q, r, k)))
    pos, nml, lbs = synthetic.make_cano_map(1024)
    opt = {"with_viewdirs": True, "channel_max": 8}
    items = synthetic.make_items(img_w=1500, img_h=2048, cano_pos_map=pos)
    fx, fy = float(items["intr"][0, 0]), float(items["intr"][1, 1])
    jnet = JNet(opt, pos, lbs, cano_nml_map=nml)
    g = jnet.init(jax.random.PRNGKey(0))["cano_gaussian"]
    tnet = TNet(opt, pos, lbs, cano_nml_map=nml, device="cpu")
    tg = tnet.cano_gaussian
    assert (jnet.n_points, jnet.n_valid) == (531_520, 517_832)
    counts = {}
    for side, conv, vals, scales, net, proj, prep, rect in (
            ("jax", jnp.asarray, dict(positions=g.get_xyz,
                                      rotations=g.get_rotation),
             g.get_scaling, jnet, japi._full_projection_traced, jpreprocess,
             jbin.tile_rect),
            ("port", torch.as_tensor, dict(positions=tg.xyz,
                                           rotations=tg.get_rotation),
             tg.get_scaling, tnet, tapi._full_projection, tpreprocess,
             tbin.tile_rect)):
        with torch.no_grad():
            it = {k: conv(items[k]) for k in ("cano2live_jnt_mats", "extr",
                                              "intr")}
            live = net.transform_cano2live(vals, it)
            vm, pm = proj(it["extr"], it["intr"], 1500, 2048)
            pre = prep(live["positions"], scales, live["rotations"], vm, pm,
                       1500 / (2 * fx), 2048 / (2 * fy), 1500, 2048)
            valid = np.asarray(jnet.valid_np)
            radii = np.where(valid, np.asarray(pre.radii), 0)
            x0, y0, x1, y1 = (np.asarray(a) for a in rect(
                pre.means2d, conv(radii), 94, 128, TILE))
        live_ok = np.asarray(pre.valid) & valid
        counts[side] = int(np.where(live_ok, (x1 - x0) * (y1 - y0), 0).sum())
    n_jax, n_port = counts["jax"], counts["port"]
    # float32 preprocess in two frameworks: a handful of ceil() flips
    assert abs(n_port - n_jax) <= 1e-4 * n_jax
    assert abs(n_jax - chip_smoke.JAX_N_PAIRS) <= 1e-4 * n_jax


# ---------------------------------------------------------------------------
# The blend's gradient and render's gradients
# ---------------------------------------------------------------------------

def _tile_cot(img5, gx, gy):
    """(H, W, 5) image cotangents -> (T, P, 8) per-tile cotangents of the
    JAX blends' [r g b depth T_final 0 0 0] output, zero past the image."""
    h, w, _ = img5.shape
    pad = np.zeros((gy * TILE, gx * TILE, 8), np.float32)
    pad[:h, :w, :5] = img5
    return pad.reshape(gy, TILE, gx, TILE, 8).transpose(0, 2, 1, 3, 4).reshape(
        gx * gy, TILE * TILE, 8)


def _backward_case(seed, w, h, n=400):
    """A scene with opaque Gaussians (pairs at the 0.99 clamp), seeded
    image cotangents and the port's plain gradient of the blend."""
    s = make_scene(n=n, seed=seed, w=w, h=h)
    s["opac"][::7] = 0.999
    rows, bins = _port_bins(s)
    gx, gy = -(-w // TILE), -(-h // TILE)
    cot = np.random.default_rng(seed).standard_normal((h, w, 5)).astype(
        np.float32)
    fwd = tblend.blend_tiles_plain(rows, bins.gid, bins.starts, gx, gy, w, h)
    t = torch.as_tensor
    got = tblend.blend_backward(rows, bins.gid, bins.starts, gx, gy, w, h,
                                *fwd, t(cot[..., :3]), t(cot[..., 3]),
                                t(cot[..., 4]))
    clamped = sum(int((geo["use"] & (geo["alpha_raw"] >= 0.99)).sum())
                  for *_, geo in tblend._batches(rows, bins.gid, bins.starts,
                                                 gx))
    assert clamped > 0
    return rows, bins, _tile_cot(cot, gx, gy), got.numpy()


def _scatter_rows(gdata, gids, n_rows):
    """(S, 16, K) per-slot gradients -> (N, 10) rows: the scatter-add of
    the JAX package's _sc_bwd; slots with gid N land in a dropped row."""
    acc = np.zeros((n_rows + 1, 10), np.float64)
    np.add.at(acc, gids.reshape(-1),
              np.asarray(gdata)[:, :10].transpose(0, 2, 1).reshape(-1, 10))
    return acc[:n_rows]


# Against jax.grad of blend_ref's cumulative-product form, the same formula
# as the plain version: sums in another order only (measured 3e-6 of a
# channel's largest entry).
REF_RTOL = 2e-5
# The TPU kernels form T as a quotient (pinc / (1 - alpha)) and their
# prefixes with log-step lane scans; the plain version takes the shifted
# cumprod and a sequential cumsum. The suffix term (total - prefix) /
# (1 - alpha) cancels and then multiplies that rounding by up to
# 1 / (1 - 0.99) = 100 at clamped pairs (measured 1.1e-4).
PALLAS_RTOL = 1e-3


def _compare_row_grads(got, want, rtol):
    """Per channel of the (N, 10) gradient: max |diff| within rtol of the
    channel's largest entry."""
    for c in range(10):
        scale = np.abs(want[:, c]).max()
        assert scale > 0, c
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=0,
                                   atol=rtol * scale, err_msg=f"channel {c}")


@pytest.mark.parametrize("w,h", [(64, 48), (60, 44)])
def test_plain_backward_matches_ragged_pallas_interpret(w, h):
    """blend_backward_plain against jax.vjp of blend_chunks (the
    _bwd_chunk_kernel path) in interpret mode, scatter-added to rows by
    chunk gid. Tiles span more than 128 pairs (the cross-chunk carry of T
    and of the four prefixes); opaque Gaussians put pairs at the 0.99 clamp;
    the 60x44 image leaves pixels of the last tile row and column outside
    it, which get no cotangent."""
    from animatablegaussians_tpu.ops.rasterize.blend_pallas import \
        blend_chunks
    rows, bins, cot_t, got = _backward_case(7, w, h)
    gx, gy = -(-w // TILE), -(-h // TILE)
    counts = (bins.starts[1:] - bins.starts[:-1]).numpy()
    assert counts.max() > 128
    data, n, tid, first, gids = _chunk_layout(rows, bins, gx * gy)
    _, vjp = jax.vjp(lambda d: blend_chunks(d, n, tid, first, tid, gx * gy,
                                            gx, TILE), data)
    want = _scatter_rows(vjp(jnp.asarray(cot_t))[0], gids, rows.shape[0])
    _compare_row_grads(got, want, rtol=PALLAS_RTOL)


def test_plain_backward_matches_rect_pallas_and_ref():
    """blend_backward_plain against jax.vjp of the rect blend_tiles (the
    _bwd_kernel path, interpret mode) and against jax.grad through
    blend_ref.blend_tiles_ref, each scatter-added to rows."""
    from animatablegaussians_tpu.ops.rasterize.blend_pallas import \
        blend_tiles as pallas_blend_tiles
    rows, bins, cot_t, got = _backward_case(2, W, H, n=200)
    counts = (bins.starts[1:] - bins.starts[:-1]).numpy()
    K = int(-(-counts.max() // 128) * 128)
    n_rows = rows.shape[0]
    rows_np = np.concatenate([rows.numpy(), np.zeros((1, 10), np.float32)])
    idx = np.full((GX * GY, K), n_rows)
    for t in range(GX * GY):
        a, b = int(bins.starts[t]), int(bins.starts[t + 1])
        idx[t, :b - a] = bins.gid[a:b].numpy()
    tile_data = np.zeros((GX * GY, 16, K), np.float32)
    tile_data[:, :10] = rows_np[idx].transpose(0, 2, 1)
    cnt = jnp.asarray(counts.astype(np.int32))
    ids = jnp.arange(GX * GY, dtype=jnp.int32)
    for name, fn in (
            ("pallas", lambda d: pallas_blend_tiles(d, cnt, ids, GX, TILE)),
            ("ref", lambda d: blend_tiles_ref(d, cnt, GX, TILE))):
        _, vjp = jax.vjp(fn, jnp.asarray(tile_data))
        want = _scatter_rows(vjp(jnp.asarray(cot_t))[0], idx, n_rows)
        _compare_row_grads(got, want, rtol=PALLAS_RTOL if name == "pallas"
                           else REF_RTOL)


@pytest.mark.parametrize("seed,n_pad", [(0, 0), (5, 30)])
def test_render_gradients_match_jax(seed, n_pad):
    """api.render's gradients with respect to means, scales, rotations,
    opacities and colours against jax.vjp of the JAX api.render
    (backend="ref", caps that drop nothing), for seeded cotangents of the
    image, depth and mask."""
    s = make_scene(n=150, seed=seed, n_pad=n_pad)
    s["opac"][::9] = 0.999
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    names = ("means", "scales", "q", "opac", "colors")
    cfg = RasterizeConfig(backend="ref", k_max=512, max_dup=16)

    def jrender(*args):
        return japi.render(*args, jnp.asarray(bg), jnp.asarray(s["extr"]),
                           jnp.asarray(s["intr"]), W, H, config=cfg,
                           valid_mask=jnp.asarray(s["valid"]))

    inputs = [jnp.asarray(s[k]) for k in names]
    assert int(jrender(*inputs)["n_overflow"]) == 0
    outs, vjp = jax.vjp(lambda *a: tuple(
        jrender(*a)[k] for k in ("render", "depth", "mask")), *inputs)
    rng = np.random.default_rng(seed)
    cots = [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in outs]
    want = vjp(tuple(jnp.asarray(c) for c in cots))

    ts = [torch.tensor(s[k], requires_grad=True) for k in names]
    t = lambda k: torch.as_tensor(s[k])
    out = tapi.render(*ts, torch.as_tensor(bg), t("extr"), t("intr"), W, H,
                      valid_mask=t("valid"))
    loss = sum((out[k] * torch.as_tensor(c)).sum()
               for k, c in zip(("render", "depth", "mask"), cots))
    loss.backward()
    for name, x, w in zip(names, ts, want):
        w = np.asarray(w)
        # float32 preprocess and blend in two frameworks, summed in another
        # order; relative to the input's whole gradient
        err = np.linalg.norm(x.grad.numpy() - w) / np.linalg.norm(w)
        assert err < 1e-4, (name, err)


def _warp_reduce_scatter(v):
    """csrc/blend_bwd.cu's butterfly over one warp: v (32 lanes, 16) ->
    each lane's v[0] after scatter_step<16,16>, <8,8>, <4,4>, <2,2> and the
    last xor-1 add, in the kernel's float32 order."""
    a = v.astype(np.float32).copy()
    lanes = np.arange(32)
    for n, o in ((16, 16), (8, 8), (4, 4), (2, 2)):
        upper = (lanes & o) != 0
        lo, hi = a[:, :n // 2].copy(), a[:, n // 2:n].copy()
        send = np.where(upper[:, None], lo, hi)
        keep = np.where(upper[:, None], hi, lo)
        a[:, :n // 2] = keep + send[lanes ^ o]
    return a[:, 0] + a[lanes ^ 1, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_backward_kernel_cta_reduction(seed):
    """The backward kernel's reduction of a batch's per-pixel terms, in
    numpy: per (warp, pair), a reduce-scatter leaves lanes 2c and 2c + 1
    with the warp's sum of channel c (channels 10-15 are padding); per
    (pair, channel), the 8 warps' sums are added in warp order. Held to the
    plain sum over the tile's 256 pixels; the order differs, so to float32
    rounding. Warps with no contributing lane write nothing (their slots
    stay 0)."""
    rng = np.random.default_rng(seed)
    n_pairs = 5
    terms = rng.standard_normal((n_pairs, 256, tblend.ROW)).astype(
        np.float32)
    terms[:, 64:96] = 0.0                   # warp 2 never contributes
    red = np.zeros((8, n_pairs, tblend.ROW), np.float32)
    for j in range(n_pairs):
        for w in range(8):
            v = np.zeros((32, 16), np.float32)
            v[:, :tblend.ROW] = terms[j, 32 * w:32 * (w + 1)]
            if not v.any():
                continue
            s = _warp_reduce_scatter(v)
            for lane in range(0, 32, 2):
                if lane >> 1 < tblend.ROW:
                    assert s[lane] == s[lane + 1]
                    red[w, j, lane >> 1] = s[lane]
    got = red[0].copy()
    for w in range(1, 8):
        got = got + red[w]
    want = terms.astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(terms).sum(axis=1).max())
