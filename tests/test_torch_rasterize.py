"""Port rasterizer (animatablegaussians_torch.ops.rasterize) against the JAX
package on the CPU: preprocess, binning pair order, the plain blend against
blend_tiles_ref and against the Pallas ragged blend in interpret mode, and
api.render end to end. The CUDA kernels themselves run only on the GPU
(chip_smoke.py compares them with these plain versions there)."""

import numpy as np
import pytest
import torch

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


def make_scene(n=60, seed=0, n_pad=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform([-0.8, -0.6, 2.0], [0.8, 0.6, 4.0],
                        (n, 3)).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    q = rng.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.2, 0.9, (n,)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    extr = np.eye(4, dtype=np.float32)
    intr = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]],
                    np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, n_pad, replace=False)] = False
    return dict(means=means, scales=scales, q=q, opac=opac, colors=colors,
                extr=extr, intr=intr, valid=valid)


def _pre_args(s, mod):
    """Arguments of preprocess for the JAX (mod=japi) or port side."""
    if mod is japi:
        vm, pm = japi._full_projection_traced(jnp.asarray(s["extr"]),
                                              jnp.asarray(s["intr"]), W, H)
        conv = jnp.asarray
    else:
        vm, pm = tapi._full_projection(torch.as_tensor(s["extr"]),
                                       torch.as_tensor(s["intr"]), W, H)
        conv = torch.as_tensor
    fx, fy = float(s["intr"][0, 0]), float(s["intr"][1, 1])
    return (conv(s["means"]), conv(s["scales"]), conv(s["q"]), vm, pm,
            W / (2 * fx), H / (2 * fy), W, H)


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


def _port_bins(s):
    pre = tpreprocess(*_pre_args(s, tapi))
    rows = tapi._pack_rows(pre, torch.as_tensor(s["opac"]),
                           torch.as_tensor(s["colors"]))
    bins = tbin.bin_gaussians(pre.means2d, pre.depths, pre.radii, pre.valid,
                              W, H, TILE)
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
    kb = 128
    rows_np = np.concatenate([rows.numpy(), np.zeros((1, 10), np.float32)])
    data, n, tid, first = [], [], [], []
    for t in range(GX * GY):
        a = int(bins.starts[t])
        for c in range(-(-int(counts[t]) // kb)):
            m = min(kb, int(counts[t]) - c * kb)
            ids = np.full(kb, rows.shape[0])
            ids[:m] = bins.gid[a + c * kb:a + c * kb + m].numpy()
            blk = np.zeros((16, kb), np.float32)
            blk[:10] = rows_np[ids].T
            data.append(blk)
            n.append(m)
            tid.append(t)
            first.append(int(c == 0))
    i32 = lambda v: jnp.asarray(np.asarray(v, np.int32))
    out = blend_chunks(jnp.asarray(np.stack(data)), i32(n), i32(tid),
                       i32(first), i32(tid), GX * GY, GX, TILE)
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


def test_full_fixture_pair_count_matches_jax():
    """At full width (the chip_smoke.py fixture: 531,520 block-packed
    Gaussians with create_from_pcd attributes, skinned, 1500x2048) the
    port's preprocess + pair count equals the JAX package's, and both equal
    the reference chip_smoke.py holds the GPU run to. The fixture comes
    from the JAX package's synthetic module and each side takes its own
    mat_to_quat; only the KNN is substituted: exact distances (a k-d tree)
    stand in for the brute-force KNN, which is too slow on the CPU at this
    size; its float32 expansion moves the count by ~0.02%."""
    import chip_smoke
    from scipy.spatial import cKDTree

    from animatablegaussians_tpu.ops import quat as jquat
    from animatablegaussians_tpu.utils import synthetic
    from animatablegaussians_torch.ops import quat as tquat

    pos, _, lbs = synthetic.make_cano_map(1024)
    flat = (np.linalg.norm(pos, axis=-1) > 0).reshape(-1)
    blocks = np.nonzero(flat.reshape(-1, 8).any(axis=1))[0]
    t = (blocks[:, None] * 8 + np.arange(8)[None]).reshape(-1)
    valid = flat[t]
    pts = pos.reshape(-1, 3)[t]
    assert (len(t), int(valid.sum())) == (531_520, 517_832)
    d, _ = cKDTree(pts.astype(np.float64)).query(pts, k=4)
    scale = np.sqrt(np.maximum((d[:, 1:] ** 2).mean(-1), 1e-7))
    scales = np.repeat(scale.astype(np.float32)[:, None], 3, axis=1)
    lbs_pad = np.zeros((len(t), lbs.shape[1]), np.float32)
    lbs_pad[valid] = lbs
    items = synthetic.make_items(img_w=1500, img_h=2048, cano_pos_map=pos)
    mats = (lbs_pad @ items["cano2live_jnt_mats"].reshape(-1, 16)).reshape(
        -1, 4, 4)
    live = (np.einsum("nij,nj->ni", mats[:, :3, :3], pts)
            + mats[:, :3, 3]).astype(np.float32)
    fx, fy = float(items["intr"][0, 0]), float(items["intr"][1, 1])
    counts = {}
    for conv, m2q, proj, prep, rect in (
            (jnp.asarray, jquat.mat_to_quat, japi._full_projection_traced,
             jpreprocess, jbin.tile_rect),
            (torch.as_tensor, tquat.mat_to_quat, tapi._full_projection,
             tpreprocess, tbin.tile_rect)):
        vm, pm = proj(conv(items["extr"]), conv(items["intr"]), 1500, 2048)
        rots = m2q(conv(np.ascontiguousarray(mats[:, :3, :3])))
        pre = prep(conv(live), conv(scales), rots, vm, pm,
                   1500 / (2 * fx), 2048 / (2 * fy), 1500, 2048)
        radii = np.where(valid, np.asarray(pre.radii), 0)
        x0, y0, x1, y1 = (np.asarray(a) for a in rect(
            pre.means2d, conv(radii), 94, 128, TILE))
        live_ok = np.asarray(pre.valid) & valid
        counts[prep] = int(np.where(live_ok, (x1 - x0) * (y1 - y0), 0).sum())
    n_jax, n_port = counts[jpreprocess], counts[tpreprocess]
    # float32 preprocess in two frameworks: a handful of ceil() flips
    assert abs(n_port - n_jax) <= 1e-4 * n_jax
    assert abs(n_jax - chip_smoke.JAX_N_PAIRS) <= 1e-4 * n_jax
