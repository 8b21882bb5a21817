"""The template stack's ops and small modules against the JAX package on
the CPU: the embedder, the volume gathers, the point/mesh geometry, the
root finding, the MLPs and densities, the hand colour field and
axis_angle_to_quat, the weight volume and its Sobel gradient, marching
cubes and Sobel normals, the NeRF ray utilities and the LR schedules.

Inputs are made with numpy from a seed and fed to both packages; the JAX
side runs as the JAX package's own tests run it. Tolerances: 1e-6 absolute
on the float32 ops whose arithmetic is the same elementwise sequence on
both sides (one ulp of the framework's sin / cos or sum order); 1e-5 where
a matmul or einsum sums in another order; indices and the host's numpy
copies exactly."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from animatablegaussians_tpu.models import density as jdensity
from animatablegaussians_tpu.models import mlp as jmlp
from animatablegaussians_tpu.models import volume as jvolume
from animatablegaussians_tpu.models.hand_avatar import HandAvatar as JHand
from animatablegaussians_tpu.ops import embedder as jemb
from animatablegaussians_tpu.ops import geometry3d as jg
from animatablegaussians_tpu.ops import grid_sample as jgs
from animatablegaussians_tpu.ops import quat as jquat
from animatablegaussians_tpu.ops.root_finding import \
    root_finding as jroot_finding
from animatablegaussians_tpu.tools import gen_pos_maps as jgpm
from animatablegaussians_tpu.training import lr_schedule as jlr
from animatablegaussians_tpu.utils import nerf as jnerf
from animatablegaussians_tpu.utils import recon as jrecon
from animatablegaussians_torch.models import density as tdensity
from animatablegaussians_torch.models import mlp as tmlp
from animatablegaussians_torch.models import volume as tvolume
from animatablegaussians_torch.models.hand_avatar import HandAvatar
from animatablegaussians_torch.ops import embedder as temb
from animatablegaussians_torch.ops import geometry3d as tg
from animatablegaussians_torch.ops import grid_sample as tgs
from animatablegaussians_torch.ops import quat as tquat
from animatablegaussians_torch.ops.root_finding import root_finding
from animatablegaussians_torch.tools import gen_pos_maps as tgpm
from animatablegaussians_torch.training import lr_schedule as tlr
from animatablegaussians_torch.utils import nerf as tnerf
from animatablegaussians_torch.utils import recon as trecon
from animatablegaussians_torch.utils.convert import mlp_state
from test_template import _uv_sphere

ATOL = 1e-6      # the same elementwise float32 sequence on both sides
ATOL_SUM = 1e-5  # a matmul / einsum / reduction in another order


def T(a, dtype=None):
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.int64 if a.dtype.kind in "iu" else torch.float32
    return torch.as_tensor(np.array(a), dtype=dtype)


def J(a):
    return jnp.asarray(np.asarray(a))


def _close(got, want, atol=ATOL, rtol=0.0):
    if torch.is_tensor(got):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _cube():
    """A closed unit cube of 12 triangles, outward faces."""
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                 np.float32) - 0.5
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def _near_ties(pts, v, f, i_a, i_b, rtol=1e-6):
    """Points whose two chosen faces differ and lie within float32
    rounding of one distance (the first index wins an exact tie in both packages, but the
    jitted JAX search rounds its distances differently from its own eager
    arithmetic by an ulp, so a near-tie may go either way)."""
    def d2(i):
        c, _ = tg.closest_point_triangle(
            T(pts), T(v[f[i, 0]]), T(v[f[i, 1]]), T(v[f[i, 2]]))
        return ((c - T(pts)) ** 2).sum(-1).numpy()
    da, db = d2(i_a), d2(i_b)
    return (i_a != i_b) & (np.abs(da - db)
                           <= rtol * np.maximum(da, db) + 1e-12)


# ---------------------------------------------------------------------------
# embedder, gathers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multires", [4, 6])
def test_embedder_matches_jax(multires):
    x = np.random.default_rng(0).uniform(-2, 2, (7, 3)).astype(np.float32)
    jfn, jdim = jemb.get_embedder(multires, 3)
    tfn, tdim = temb.get_embedder(multires, 3)
    assert tdim == jdim == 3 * (1 + 2 * multires)
    got = tfn(T(x))
    _close(got, jfn(J(x)))
    # the reference's order: [x, sin(f0 x), cos(f0 x), sin(f1 x), ...]
    _close(got[:, 3:6], np.sin(x), 1e-6)
    _close(got[:, 6:9], np.cos(x), 1e-6)
    _close(got[:, 9:12], np.sin(2 * x), 1e-6)


def test_volume_gathers_match_jax():
    """Trilinear and nearest gathers on a (5, 6, 7, 2) volume, points in
    and outside [0, 1] and at half voxels (round half to even)."""
    rng = np.random.default_rng(1)
    vol = rng.standard_normal((5, 6, 7, 2)).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, (40, 3)).astype(np.float32)
    half = (np.array([[0.5, 1.5, 2.5], [2.5, 3.5, 4.5], [3.5, 0.5, 5.5]])
            / np.array([4, 5, 6])).astype(np.float32)
    pts = np.concatenate([pts, half, [[0, 0, 0], [1, 1, 1]]]).astype(
        np.float32)
    _close(tgs.sample_volume_trilinear(T(vol), T(pts)),
           jgs.sample_volume_trilinear(J(vol), J(pts)))
    np.testing.assert_array_equal(
        tgs.sample_volume_nearest(T(vol), T(pts)).numpy(),
        np.asarray(jgs.sample_volume_nearest(J(vol), J(pts))))


def test_trilinear_gather_matches_grid_sample():
    """Where the two are defined alike (align_corners, border padding) the
    gather equals F.grid_sample on the NDHW volume with a zyx grid."""
    rng = np.random.default_rng(2)
    vol = T(rng.standard_normal((5, 6, 7, 3)).astype(np.float32))
    pts = T(rng.uniform(-0.3, 1.3, (50, 3)).astype(np.float32))
    got = tgs.sample_volume_trilinear(vol, pts)
    grid = (pts.clamp(0, 1) * 2 - 1).flip(-1)[None, :, None, None]
    want = F.grid_sample(vol.permute(3, 0, 1, 2)[None], grid,
                         mode="bilinear", padding_mode="border",
                         align_corners=True)[0, :, :, 0, 0].T
    _close(got, want, ATOL_SUM)


# ---------------------------------------------------------------------------
# point / mesh geometry
# ---------------------------------------------------------------------------

def test_closest_point_triangle_matches_jax():
    """Random and degenerate triangles; points in every Voronoi region."""
    rng = np.random.default_rng(3)
    tri = rng.standard_normal((24, 3, 3)).astype(np.float32)
    tri[20, 2] = tri[20, 1]                       # an edge triangle
    tri[21, 1] = tri[21, 0]
    tri[22] = tri[22, 0]                          # a point triangle
    pts = rng.standard_normal((24, 3)).astype(np.float32) * 2
    args = [pts, tri[:, 0], tri[:, 1], tri[:, 2]]
    c_t, b_t = tg.closest_point_triangle(*map(T, args))
    c_j, b_j = jg.closest_point_triangle(*map(J, args))
    _close(c_t, c_j, ATOL_SUM)
    _close(b_t, b_j, ATOL_SUM)


@pytest.mark.parametrize("mesh", ["cube", "sphere"])
def test_nearest_face_matches_jax(mesh):
    """Nearest face, distance and barycentric weights, with ties: the
    mesh's centre is equidistant from several faces (the first index
    wins, as in JAX), and points on vertices and edges."""
    v, f = _cube() if mesh == "cube" else _uv_sphere()
    rng = np.random.default_rng(4)
    pts = np.concatenate([
        rng.uniform(-1, 1, (60, 3)), np.zeros((1, 3)), v[:5],
        0.5 * (v[f[:3, 0]] + v[f[:3, 1]])]).astype(np.float32)
    d_t, i_t, b_t = tg.nearest_face(T(pts), T(v), T(f), chunk=16)
    d_j, i_j, b_j = jg.nearest_face(J(pts), J(v), J(f), chunk=16)
    _close(d_t, d_j, ATOL_SUM)
    tie = _near_ties(pts, v, f, i_t.numpy(), np.asarray(i_j))
    if mesh == "cube":               # the centre: 12 exact ties
        assert int(i_t[60]) == int(i_j[60]) == 0
    np.testing.assert_array_equal(i_t.numpy()[~tie], np.asarray(i_j)[~tie])
    _close(b_t[~tie], np.asarray(b_j)[~tie], ATOL_SUM)
    # at a near-tie both faces' closest points are the same surface point
    # (or two at one distance inside the mesh); the interpolated position
    # is the closest point either way
    _close(tg.barycentric_interpolate(T(v), T(f), i_t, b_t)[~tie],
           np.asarray(jg.barycentric_interpolate(J(v), J(f), i_j, b_j))[
               ~tie], ATOL_SUM)


@pytest.mark.parametrize("method", ["NN", "barycentric"])
def test_calc_blending_weight_matches_jax(method):
    v, f = _uv_sphere()
    rng = np.random.default_rng(5)
    lbs = rng.random((len(v), 6)).astype(np.float32)
    lbs /= lbs.sum(1, keepdims=True)
    pts = rng.uniform(-0.7, 0.7, (50, 3)).astype(np.float32)
    w_t, n_t = tg.calc_blending_weight(T(pts), T(v), T(f), T(lbs),
                                       near_thres=0.2, method=method)
    w_j, n_j = jg.calc_blending_weight(J(pts), J(v), J(f), J(lbs),
                                       near_thres=0.2, method=method)
    keep = np.ones(len(pts), bool)
    if method == "barycentric":      # near-ties may pick either face
        _, i_t, _ = tg.nearest_face(T(pts), T(v), T(f))
        _, i_j, _ = jg.nearest_face(J(pts), J(v), J(f))
        keep = ~_near_ties(pts, v, f, i_t.numpy(), np.asarray(i_j))
        assert keep.sum() > 40
    _close(w_t[keep], np.asarray(w_j)[keep], ATOL_SUM)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert 0 < int(n_t.sum()) < len(pts)


def test_near_far_smpl_matches_jax():
    """Rays through, grazing and missing the vertices' spheres."""
    v, _ = _uv_sphere(r=0.5)
    rng = np.random.default_rng(6)
    o = np.tile([[0, 0, -2.0]], (40, 1)).astype(np.float32)
    d = rng.standard_normal((40, 3)).astype(np.float32) * 0.4
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    got = tg.near_far_smpl(T(v), T(o), T(d), radius=0.1, chunk=16)
    want = jg.near_far_smpl(J(v), J(o), J(d), radius=0.1, chunk=16)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    hit = got[2].numpy()
    assert 0 < hit.sum() < len(hit)
    for g_, w_ in zip(got[:2], want[:2]):
        _close(g_.numpy()[hit], np.asarray(w_)[hit], ATOL_SUM)


def test_skinning_matches_jax():
    rng = np.random.default_rng(7)
    pts = rng.standard_normal((20, 3)).astype(np.float32)
    nrm = rng.standard_normal((20, 3)).astype(np.float32)
    lbs = rng.random((20, 5)).astype(np.float32)
    mats = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    mats[:, :3] += 0.1 * rng.standard_normal((5, 3, 4)).astype(np.float32)
    out_t, m_t = tg.skinning(T(pts), T(lbs), T(mats), return_pt_mats=True)
    out_j, m_j = jg.skinning(J(pts), J(lbs), J(mats), return_pt_mats=True)
    _close(out_t, out_j, ATOL_SUM)
    _close(m_t, m_j, ATOL_SUM)
    _close(tg.skinning_normal(T(nrm), T(lbs), T(mats)),
           jg.skinning_normal(J(nrm), J(lbs), J(mats)), ATOL_SUM)


def _two_joint_volume(res=24):
    """Weights varying along x (a sigmoid), their analytic gradient."""
    xs = np.linspace(0, 1, res)
    w0 = 1.0 / (1.0 + np.exp((xs - 0.5) * 10))
    wv = np.zeros((res, res, res, 2), np.float32)
    wv[..., 0] = w0[:, None, None]
    wv[..., 1] = 1.0 - w0[:, None, None]
    dw = np.gradient(w0, (xs[1] - xs[0]) * 2)
    gv = np.zeros((res, res, res, 6), np.float32)
    gv[..., 0] = dw[:, None, None]
    gv[..., 3] = -dw[:, None, None]
    mats = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    mats[0, :3, 3] = [0.02, 0.01, 0.0]
    mats[1, :3, 3] = [-0.02, 0.0, 0.01]
    bounds = np.asarray([[-1, -1, -1], [1, 1, 1]], np.float32)
    return wv, gv, mats, bounds


def test_root_finding_matches_jax_and_inverts_skinning():
    """The Newton iterations on the card's plain path against JAX's, and
    their solution re-skinned lands on the target (as
    tests/test_geometry3d.py's case)."""
    wv, gv, mats, bounds = _two_joint_volume()
    cano = np.random.default_rng(2).uniform(-0.5, 0.5, (32, 3)).astype(
        np.float32)
    w = tgs.sample_volume_trilinear(T(wv), (T(cano) + 1) / 2)
    posed = tg.skinning(T(cano), w, T(mats))
    xc = root_finding(T(wv), T(gv), posed, posed, T(mats), T(bounds),
                      lam=0.1, iter_num=10)
    xc_j = jroot_finding(J(wv), J(gv), J(posed.numpy()), J(posed.numpy()),
                         J(mats), J(bounds), lam=0.1, iter_num=10)
    _close(xc, xc_j, ATOL_SUM)
    w2 = tgs.sample_volume_trilinear(T(wv), (xc + 1) / 2)
    err = (tg.skinning(xc, w2, T(mats)) - posed).abs().max()
    assert float(err) < 1e-3


# ---------------------------------------------------------------------------
# MLPs, densities, hands
# ---------------------------------------------------------------------------

def _carry(module, params, prefix=""):
    sd = mlp_state(jax.tree_util.tree_map(np.asarray, params), prefix)
    module.load_state_dict(sd)
    return module


def test_mlp_linear_matches_jax():
    net_j = jmlp.MLPLinear(7, 3, [16, 16, 16], res_layers=[2],
                           nlactv="relu", last_op="sigmoid")
    p = net_j.init(jax.random.PRNGKey(0))
    net_t = tmlp.MLPLinear(7, 3, [16, 16, 16], res_layers=[2],
                           nlactv="relu", last_op="sigmoid", device="cpu")
    assert [tuple(l.weight.shape[::-1]) for l in net_t.layers] == \
        net_j.layer_dims
    _carry(net_t, p)
    x = np.random.default_rng(8).standard_normal((9, 7)).astype(np.float32)
    y_t, inter_t = net_t(T(x), return_inter_layer=(1,))
    y_j, inter_j = net_j.apply(p, J(x), return_inter_layer=(1,))
    _close(y_t, y_j, ATOL_SUM)
    _close(inter_t[0], inter_j[0], ATOL_SUM)


def test_sdf_mlp_init_and_forward_match_jax():
    """The template's geometry MLP at full width (39 inputs): the port's
    own geometric init has the JAX layout and the sphere-like SDF; with
    the JAX parameters carried across the outputs agree, softplus's
    linear branch (beta x > 20) included."""
    dims = dict(in_channels=39, out_channels=257,
                inter_channels=[512, 256, 256, 256, 256, 256],
                res_layers=[4], bias=0.7)
    net_j = jmlp.SdfMLP(**dims)
    p = jax.jit(net_j.init)(jax.random.PRNGKey(0))
    net_t = tmlp.SdfMLP(**dims, device="cpu", seed=0)
    for lt, lj in zip(net_t.layers, p):
        assert tuple(lt.weight.shape) == np.asarray(lj["weight"]).T.shape
        assert lt.g is not None and lt.g.shape == np.asarray(lj["g"]).shape
    emb, _ = temb.get_embedder(6, 3)
    pts = T([[0.0, 0, 0], [2.0, 0, 0], [0, 3.0, 0]])
    sdf = net_t(emb(pts))[:, 0].detach().numpy()
    assert sdf[0] < 0 < sdf[1] < sdf[2]
    _carry(net_t, p)
    x = np.random.default_rng(9).uniform(-1, 1, (16, 3)).astype(np.float32)
    jemb_fn, _ = jemb.get_embedder(6, 3)
    _close(net_t(emb(T(x))),
           jax.jit(net_j.apply)(p, jemb_fn(J(x))), ATOL_SUM)
    z = np.linspace(-0.5, 0.5, 41).astype(np.float32)
    _close(tmlp.softplus_beta(T(z)), jmlp.softplus_beta(J(z)), ATOL)


def test_densities_match_jax():
    sdf = np.concatenate([np.linspace(-0.1, 0.1, 21), [0.0, -1.0, 1.0]]
                         ).astype(np.float32)[:, None]
    lj = jdensity.LaplaceDensity(beta_init=0.01)
    pj = lj.init()
    lt = tdensity.LaplaceDensity(beta_init=0.01, device="cpu")
    _close(lt(T(sdf)), lj.apply(pj, J(sdf)), 1e-6 * 100)   # 1 / beta = 99
    _close(lt.get_beta(), lj.get_beta(pj))
    _close(tdensity.AbsDensity()(T(sdf)),
           jdensity.AbsDensity().apply({}, J(sdf)))
    _close(tdensity.SimpleDensity()(T(sdf)),
           jdensity.SimpleDensity().apply({}, J(sdf)))


def test_hand_avatar_and_axis_angle_to_quat_match_jax():
    aa = np.concatenate([np.zeros((1, 3)), 1e-9 * np.ones((1, 3)),
                         np.random.default_rng(10).standard_normal((6, 3))]
                        ).astype(np.float32)
    q = tquat.axis_angle_to_quat(T(aa))
    _close(q, jquat.axis_angle_to_quat(J(aa)))
    np.testing.assert_array_equal(q[0].numpy(), [1, 0, 0, 0])

    hj = JHand()
    p = hj.init(jax.random.PRNGKey(0))
    ht = _carry(HandAvatar(device="cpu"), p, "tex_mlp.")
    rng = np.random.default_rng(11)
    xyz = rng.standard_normal((10, 3)).astype(np.float32)
    sdf = rng.standard_normal((10, 1)).astype(np.float32)
    pose = (0.3 * rng.standard_normal(45)).astype(np.float32)
    for hp in (np.zeros(45, np.float32), pose):
        c = ht(T(xyz), T(sdf), None, T(hp))
        _close(c, hj.apply(p, J(xyz), J(sdf), None, J(hp)), ATOL_SUM)
        assert c.shape == (10, 3) and bool(((c >= 0) & (c <= 1)).all())


# ---------------------------------------------------------------------------
# the weight volume
# ---------------------------------------------------------------------------

def test_weight_volume_matches_jax():
    """The Sobel gradient volume (F.conv3d against lax.conv) and the
    volume's trilinear weight / sdf and nearest gradient queries."""
    rng = np.random.default_rng(12)
    res, nj = 9, 5
    w = rng.random((res, res + 1, res + 2, nj)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    data = dict(diff_weight_volume=w, ori_weight_volume=w[..., ::-1].copy(),
                sdf_volume=rng.standard_normal(w.shape[:3]).astype(
                    np.float32),
                volume_bounds=np.array([[-1, -1.2, -0.8], [1, 0.9, 1.1]],
                                       np.float32))
    vj = jvolume.CanoBlendWeightVolume(data=data)
    vt = tvolume.CanoBlendWeightVolume(data=data, device="cpu")
    _close(vt.grad_volume, vj.grad_volume, ATOL_SUM)
    pts = rng.uniform(-1.2, 1.2, (30, 3)).astype(np.float32)
    for vt_ in ("diff", "ori"):
        _close(vt.forward_weight(T(pts), volume_type=vt_),
               vj.forward_weight(J(pts), volume_type=vt_), ATOL)
    _close(vt.forward_sdf(T(pts)), vj.forward_sdf(J(pts)), ATOL)
    _close(vt.forward_weight_grad(T(pts)), vj.forward_weight_grad(J(pts)),
           ATOL_SUM)


# ---------------------------------------------------------------------------
# marching cubes, NeRF utilities, LR schedules
# ---------------------------------------------------------------------------

def test_marching_cubes_and_sobel_normals_match_jax():
    """The numpy copies give the JAX package's mesh and normals exactly."""
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, 14)] * 3, indexing="ij"),
                 -1)
    sdf = (np.linalg.norm(g * [1.0, 1.3, 0.8], axis=-1) - 0.6).astype(
        np.float32)
    bounds = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    vt, ft = trecon.extract_mesh_from_sdf(sdf, bounds)
    vj, fj = jrecon.extract_mesh_from_sdf(sdf, bounds)
    assert len(ft) > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(trecon.compute_sobel_normals(sdf),
                                  jrecon.compute_sobel_normals(sdf))


def test_sample_pts_sample_pdf_raw2outputs_match_jax():
    rng = np.random.default_rng(13)
    R, S = 5, 12
    o = rng.standard_normal((R, 3)).astype(np.float32)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    near = rng.uniform(0.5, 1, R).astype(np.float32)
    far = near + rng.uniform(1, 2, R).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (R, S)))
    pj, zj = jnerf.sample_pts_on_rays(J(o), J(d), J(near), J(far), S,
                                      perturb=True, rng=key)
    pt, zt = tnerf.sample_pts_on_rays(T(o), T(d), T(near), T(far), S,
                                      perturb=True, t_rand=T(u))
    _close(zt, zj, ATOL_SUM)
    _close(pt, pj, ATOL_SUM)

    w = rng.random((R, S - 1)).astype(np.float32)
    w[0] = 0.0                                    # a flat PDF
    for det in (True, False):
        uk = jax.random.PRNGKey(4)
        got = tnerf.sample_pdf(T(zt.numpy()[:, :-1] + 0.0), T(w), 9,
                               det=det, u=None if det else T(np.asarray(
                                   jax.random.uniform(uk, (R, 9)))))
        want = jnerf.sample_pdf(J(zt.numpy()[:, :-1]), J(w), 9, rng=uk,
                                det=det)
        _close(got, want, ATOL_SUM)

    raw = rng.random((R, S, 4)).astype(np.float32)
    for white in (False, True):
        for g_, w_ in zip(tnerf.raw2outputs(T(raw), zt, white),
                          jnerf.raw2outputs(J(raw), zj, white)):
            _close(g_, w_, ATOL_SUM, rtol=1e-6)


def test_host_ray_utilities_match_jax():
    """gen_uv, get_rays, get_near_far, get_bound_2d_mask (also with an
    AABB corner behind the camera, whose cast to int numpy warns about in
    both packages) and the seeded ray draw: the numpy copies equal the JAX
    package's."""
    rng = np.random.default_rng(14)
    H, W = 40, 48
    extr = np.eye(4, dtype=np.float32)
    extr[:3, 3] = [0.05, -0.02, 2.0]
    intr = np.array([[60, 0, W / 2], [0, 60, H / 2], [0, 0, 1]], np.float32)
    bounds = np.array([[-0.4, -0.5, -0.3], [0.4, 0.5, 0.3]], np.float32)
    np.testing.assert_array_equal(tnerf.gen_uv(W, H), jnerf.gen_uv(W, H))
    uv = tnerf.gen_uv(W, H).reshape(-1, 2)
    for a, b in zip(tnerf.get_rays(uv, extr, intr),
                    jnerf.get_rays(uv, extr, intr)):
        np.testing.assert_array_equal(a, b)
    rd, ro = tnerf.get_rays(uv, extr, intr)
    for a, b in zip(tnerf.get_near_far(bounds, ro, rd),
                    jnerf.get_near_far(bounds, ro, rd)):
        np.testing.assert_array_equal(a, b)
    # a camera inside the box: four corners behind it overflow the cast
    inside = extr.copy()
    inside[:3, 3] = [-0.5, -0.02, -0.1]
    for e in (extr, inside):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            got = tnerf.get_bound_2d_mask(bounds, intr, e, H, W)
        np.testing.assert_array_equal(
            got, jnerf.get_bound_2d_mask(bounds, intr, e, H, W))
        assert bool(caught) == (e is inside)

    color = rng.random((H, W, 3)).astype(np.float32)
    mask = np.zeros((H, W), bool)
    mask[10:30, 15:35] = True
    unsample = np.zeros((H, W), np.float32)
    unsample[10, :] = 1.0
    got = tnerf.sample_rays_for_training(
        color, mask, extr, intr, bounds, sample_num=64,
        unsample_region_mask=unsample, rng=np.random.default_rng(5))
    want = jnerf.sample_rays_for_training(
        color, mask, extr, intr, bounds, sample_num=64,
        unsample_region_mask=unsample, rng=np.random.default_rng(5))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["uv"]) == 64


@pytest.mark.parametrize("cfg", [
    dict(type="Step", initial=5e-4, interval=40, factor=0.9, min=4.2e-4),
    dict(type="Step", initial=1e-3, interval=7, factor=0.5),
    dict(type="Warmup", initial=1e-5, final=1e-3, length=30),
    dict(type="Constant", value=3e-4)])
def test_lr_schedules_match_jax(cfg):
    """At k = 0, interval - 1, interval and past the floor, and through a
    LambdaLR: update k of an Adam takes the schedule at k, as optax."""
    st = tlr.get_learning_rate_schedule(**cfg)
    sj = jlr.get_learning_rate_schedule(**cfg)
    n = cfg.get("interval", cfg.get("length", 10))
    ks = [0, n - 1, n, n + 1, 3 * n, 50 * n]
    np.testing.assert_allclose([st(k) for k in ks],
                               [float(sj(jnp.asarray(k))) for k in ks],
                               rtol=1e-6)
    if "min" in cfg:
        assert st(50 * n) == cfg["min"] and st(0) == cfg["initial"]
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.Adam([p], lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, st)
    for k in range(n + 2):
        assert opt.param_groups[0]["lr"] == pytest.approx(st(k), rel=1e-12)
        p.grad = torch.ones(3)
        opt.step()
        sched.step()


def test_vertex_normals_copy_matches_jax():
    v, f = _uv_sphere(n_theta=6, n_phi=9, r=0.7)
    np.testing.assert_array_equal(tgpm.vertex_normals(v, f),
                                  jgpm.vertex_normals(v, f))
