"""The body-model families of the port (``models/smplx``: SMPL, SMPL+H,
MANO, FLAME, ``lbs.batch_rodrigues``, ``SMPLX.from_npz(gender=)``)
against the JAX package's on the CPU, on synthetic archives written by
``tools/capture_fixture.write_body_model`` (the real archives are not in
the repository).

Tolerances: vertices, joints, ``A`` and ``full_pose`` within 1e-5
relative and 1e-5 absolute (float32 on both sides, einsums summed in
another order; the random models' vertices are N(0, 1) metres);
``batch_rodrigues`` within 1e-6. ``SMPLX`` is held bit for bit to a
restatement of its forward as it stood before the families moved its
joint extension to a module function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.models import smplx as jsmplx
from animatablegaussians_tpu.models.smplx.lbs import \
    batch_rodrigues as jbatch_rodrigues
from animatablegaussians_torch.models import smplx as tsmplx
from animatablegaussians_torch.models.smplx.lbs import (
    blend_shapes, find_dynamic_lmk_idx_and_bcoords, lbs, vertices2landmarks)
from animatablegaussians_torch.tools import capture_fixture as cf

RTOL, ATOL = 1e-5, 1e-5
KEYS = ("vertices", "joints", "A", "full_pose")
B = 3


def _close(got: dict, want: dict, keys=KEYS):
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _jax_data(path, num_betas=10, n_expr=0, landmarks=False):
    """The JAX SMPLXData of an archive, laid out as the JAX loaders lay
    out SMPL's: FLAME's expression directions are shapedirs[..., 300:],
    MANO's hands are taken by the constructor."""
    raw = np.load(path)
    f32 = lambda k: jnp.asarray(np.asarray(raw[k], np.float32))  # noqa
    sd = np.asarray(raw["shapedirs"], np.float32)
    pd = np.asarray(raw["posedirs"], np.float32)
    pd = pd.reshape(-1, pd.shape[-1]).T
    V = sd.shape[0]
    parents = np.asarray(raw["kintree_table"])[0].astype(np.int64)
    parents[0] = 0
    z45 = jnp.zeros(45)
    kw = {}
    if landmarks:
        kw = dict(lmk_faces_idx=jnp.asarray(raw["lmk_faces_idx"]),
                  lmk_bary_coords=f32("lmk_bary_coords"),
                  dynamic_lmk_faces_idx=jnp.asarray(
                      raw["dynamic_lmk_faces_idx"]),
                  dynamic_lmk_bary_coords=f32("dynamic_lmk_bary_coords"))
    return jsmplx.SMPLXData(
        v_template=f32("v_template"),
        shapedirs=jnp.asarray(sd[..., :num_betas]),
        expr_dirs=jnp.asarray(sd[..., 300:300 + n_expr] if n_expr
                              else np.zeros((V, 3, 0), np.float32)),
        posedirs=jnp.asarray(pd), J_regressor=f32("J_regressor"),
        lbs_weights=f32("weights"),
        left_hand_components=jnp.zeros((1, 45)),
        right_hand_components=jnp.zeros((1, 45)),
        left_hand_mean=z45, right_hand_mean=z45, parents=parents,
        faces=np.asarray(raw["f"], np.int64), **kw)


def _args(rng, **dims) -> dict:
    """(B, dim) float32 draws: 0.4 N(0, 1) poses, N(0, 1) betas etc."""
    return {k: ((1.0 if k in ("betas", "transl", "expression") else 0.4)
                * rng.standard_normal((B, d))).astype(np.float32)
            for k, d in dims.items()}


def _run(jm, tm, args: dict):
    # one compile of the whole JAX forward (op-by-op it compiles each op)
    want = jax.jit(lambda a: jm(**a))(
        {k: jnp.asarray(v) for k, v in args.items()})
    with torch.no_grad():
        got = tm(**{k: torch.as_tensor(v) for k, v in args.items()})
    return got, want


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    d = tmp_path_factory.mktemp("body_models")
    return {f: cf.write_body_model(str(d / f"{f}.npz"), f,
                                   **({} if f == "smplh" else
                                      dict(n_verts=300, n_faces=400)),
                                   seed=i)
            for i, f in enumerate(cf.FAMILIES)}


def test_batch_rodrigues_matches_jax():
    aa = (np.random.default_rng(0).standard_normal((4, 5, 3))).astype(
        np.float32)
    aa[0, 0] = 0.0
    got = tsmplx.batch_rodrigues(torch.as_tensor(aa)).numpy()
    want = np.asarray(jbatch_rodrigues(jnp.asarray(aa)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("transl", [False, True])
def test_smpl_matches_jax(archives, transl):
    jm = jsmplx.SMPL.from_npz(archives["smpl"])
    tm = tsmplx.SMPL.from_npz(archives["smpl"], device="cpu")
    assert tm.data.expr_dirs.shape == (300, 3, 0)
    dims = dict(betas=10, global_orient=3, body_pose=69)
    if transl:
        dims["transl"] = 3
    got, want = _run(jm, tm, _args(np.random.default_rng(1), **dims))
    assert got["joints"].shape == (B, 24, 3)
    _close(got, want)


@pytest.mark.parametrize("case", ["pca", "full", "flat_hand_mean"])
def test_smplh_matches_jax(archives, case):
    kw = dict(pca=dict(use_pca=True, num_pca_comps=6),
              full=dict(use_pca=False),
              flat_hand_mean=dict(use_pca=False, flat_hand_mean=True))[case]
    jm = jsmplx.SMPLH.from_npz(archives["smplh"], num_betas=16, **kw)
    tm = tsmplx.SMPLH.from_npz(archives["smplh"], num_betas=16,
                               device="cpu", **kw)
    hand = 6 if case == "pca" else 45
    args = _args(np.random.default_rng(2), betas=16, global_orient=3,
                 body_pose=63, left_hand_pose=hand, right_hand_pose=hand,
                 transl=3)
    got, want = _run(jm, tm, args)
    # the real topology appends the 21 extra landmark joints
    assert got["joints"].shape == (B, 52 + 21, 3)
    _close(got, want)


@pytest.mark.parametrize("case", ["pca", "no_components", "flat_hand_mean"])
def test_mano_matches_jax(archives, case):
    raw = np.load(archives["mano"])
    comps, mean = raw["hands_components"], raw["hands_mean"]
    data = _jax_data(archives["mano"])
    if case == "pca":
        jm = jsmplx.MANO(data, jnp.asarray(comps), jnp.asarray(mean))
        tm = tsmplx.MANO.from_npz(archives["mano"], device="cpu")
        hand = 6
    elif case == "no_components":
        # PCA asked for, but without components MANO takes 45 values
        jm = jsmplx.MANO(data, None, jnp.asarray(mean))
        tm = tsmplx.MANO.from_npz(archives["mano"], device="cpu",
                                  hand_components=None)
        hand = 45
    else:
        jm = jsmplx.MANO(data, jnp.asarray(comps), jnp.asarray(mean),
                         use_pca=False, flat_hand_mean=True)
        tm = tsmplx.MANO.from_npz(archives["mano"], device="cpu",
                                  use_pca=False, flat_hand_mean=True)
        hand = 45
    assert tm.use_pca == (case == "pca")
    args = _args(np.random.default_rng(3), betas=10, global_orient=3,
                 hand_pose=hand, transl=3)
    got, want = _run(jm, tm, args)
    assert got["joints"].shape == (B, 16, 3)
    _close(got, want)


@pytest.mark.parametrize("contour", [False, True])
def test_flame_matches_jax(archives, contour):
    jm = jsmplx.FLAME(_jax_data(archives["flame"], n_expr=10,
                                landmarks=True), use_face_contour=contour)
    tm = tsmplx.FLAME.from_npz(archives["flame"], device="cpu",
                               use_face_contour=contour)
    assert tm.neck_kin_chain == [0]
    rng = np.random.default_rng(4)
    args = _args(rng, betas=10, global_orient=3, neck_pose=3, jaw_pose=3,
                 leye_pose=3, reye_pose=3, expression=10, transl=3)
    # FLAME's contour reads the chain [0], the global orient: rotations
    # about y that reach the table's three branches (a negative angle past
    # -39 degrees, one within, a positive one past the clamp at 39)
    args["global_orient"][:] = [[0, 0.9, 0], [0, 0.3, 0], [0, -1.2, 0]]
    got, want = _run(jm, tm, args)
    assert got["joints"].shape == (B, 5 + 51 + (17 if contour else 0), 3)
    _close(got, want)


def _smplx_forward_before(m, betas, global_orient, body_pose,
                          left_hand_pose, right_hand_pose, transl,
                          expression, jaw_pose):
    """SMPLX.forward as it stood before the families (its joint extension
    a method), for the bit-for-bit check."""
    d = m.data
    Bn = betas.shape[0]
    z = torch.zeros((Bn, 3))
    if m.use_pca:
        left_hand_pose = left_hand_pose @ \
            d.left_hand_components[:m.num_pca_comps]
        right_hand_pose = right_hand_pose @ \
            d.right_hand_components[:m.num_pca_comps]
    full_pose = torch.cat([
        global_orient.reshape(Bn, 3), body_pose.reshape(Bn, 63),
        jaw_pose, z, z, left_hand_pose.reshape(Bn, 45),
        right_hand_pose.reshape(Bn, 45)], dim=1) + m.pose_mean()[None]
    verts, joints, A = lbs(torch.cat([betas, expression], dim=-1),
                           full_pose, d.v_template,
                           torch.cat([d.shapedirs, d.expr_dirs], dim=-1),
                           d.posedirs, d.J_regressor, d.parents,
                           d.lbs_weights)
    if m.extra_joints_idxs is not None:
        joints = torch.cat([joints, verts[:, m.extra_joints_idxs]], dim=1)
    if d.lmk_faces_idx is not None:
        lmk_f = d.lmk_faces_idx[None].expand((Bn,) + d.lmk_faces_idx.shape)
        lmk_b = d.lmk_bary_coords[None].expand(
            (Bn,) + d.lmk_bary_coords.shape)
        if m.use_face_contour:
            dyn_f, dyn_b = find_dynamic_lmk_idx_and_bcoords(
                full_pose, d.dynamic_lmk_faces_idx,
                d.dynamic_lmk_bary_coords, m.neck_kin_chain)
            lmk_f = torch.cat([lmk_f, dyn_f], dim=1)
            lmk_b = torch.cat([lmk_b, dyn_b], dim=1)
        joints = torch.cat([joints, vertices2landmarks(
            verts, d.faces, lmk_f, lmk_b)], dim=1)
    verts = verts + transl[:, None]
    joints = joints + transl[:, None]
    A = A.clone()
    A[:, :, :3, 3] = A[:, :, :3, 3] + transl[:, None]
    v_shaped = d.v_template[None] + blend_shapes(betas, d.shapedirs)
    return dict(vertices=verts, joints=joints, A=A, v_shaped=v_shaped,
                full_pose=full_pose)


@pytest.mark.parametrize("case", ["pca", "landmarks"])
def test_smplx_unchanged_bit_for_bit(tmp_path, case):
    from tests.test_torch_data import _write_landmark_smplx
    path = str(tmp_path / "smplx.npz")
    if case == "landmarks":
        _write_landmark_smplx(path)
        kw = dict(use_pca=False, use_face_contour=True)
    else:
        cf.write_smplx(path)
        kw = dict(use_pca=True)
    m = tsmplx.SMPLX.from_npz(path, device="cpu", **kw)
    # gender is the second parameter, accepted and ignored, as in JAX
    m_f = tsmplx.SMPLX.from_npz(path, "female", device="cpu", **kw)
    hand = 6 if case == "pca" else 45
    args = {k: torch.as_tensor(v) for k, v in _args(
        np.random.default_rng(5), betas=10, global_orient=3, body_pose=63,
        left_hand_pose=hand, right_hand_pose=hand, transl=3, expression=10,
        jaw_pose=3).items()}
    with torch.no_grad():
        got = m(**args)
        got_f = m_f(**args)
        want = _smplx_forward_before(m, **args)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got_f[k], want[k]), k
