"""TemplateNet and the template step against the JAX package on the CPU.

One module-scoped JAX fixture: the full-width TemplateNet (its MLP widths
are fixed; ``multires`` 2 and a few dozen points keep it small) on a
random 8^3 x 55 weight volume, a UV-sphere "SMPL" with random skinning
weights and random joint transforms, and two small sphere "hands". The
JAX parameters are carried across with ``template_params_from_jax``; the
JAX package's own jitter and view-noise draws (its key split) are passed
to the port.

Tolerances: the rendered maps and normals 1e-5 absolute (float32 matmuls
summed in another order); loss terms 1e-5 relative at step 0 and 1e-4
at steps 1 and 2, which start from the parameters below (largest reading
1.2e-5, the eikonal term of step 1, measured); step-0 gradients
5e-4 relative L2 per parameter group: the SMPL-sphere near/far is
b +- sqrt(b^2 - c) with b^2 ~ c ~ 4 here, so an ulp of the two
frameworks' sums moves a far bound by up to 1.8e-5 (measured), and the
samples with it; the largest reading, right_hand's, is 1.8e-4 (measured;
the other groups read below 1e-4). Parameters after the first Adam
update 5e-5 absolute, a tenth of lr = 5e-4: an element moves by
lr g / (|g| + 1e-8), so where |g| is near Adam's eps the gradient's
relative error above reaches the update; the largest reading is 2.5e-5
(measured, 4 of 131,072 elements of one layer). Later updates are held
through the loss terms only: an element whose gradient is within that
noise of 0 moves by about lr either way (measured: 33 elements of a hand
layer 4.1e-4 apart after the second update)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from animatablegaussians_tpu.models.template import TemplateNet as JNet
from animatablegaussians_tpu.models.volume import \
    CanoBlendWeightVolume as JVolume
from animatablegaussians_tpu.tools.gen_pos_maps import vertex_normals
from animatablegaussians_tpu.training import template_trainer as jtt
from animatablegaussians_torch.models.template import TemplateNet
from animatablegaussians_torch.models.volume import CanoBlendWeightVolume
from animatablegaussians_torch.training import template_trainer as tt
from animatablegaussians_torch.utils.convert import template_params_from_jax
from tests.test_template import _uv_sphere

J_NUM, RES, R, S = 55, 8, 6, 8
ATOL_MAP = 1e-5
RTOL_LOSS = 1e-5
RTOL_LOSS_LATER = 1e-4
RTOL_GRAD = 5e-4
ATOL_PARAM = 5e-5
LR = dict(type="Step", initial=5e-4, interval=2, factor=0.9, min=4.4e-4)
LOSS_W = dict(color=1.0, mask=1.0, eikonal=0.1)
GROUPS = ("geo_mlp", "tex_mlp", "density", "left_hand", "right_hand")


def _opt(with_hand, root):
    return dict(multires=2, with_hand=with_hand, use_root_finding=root,
                volume_type="diff", use_viewdir=False)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    w = rng.random((RES, RES, RES, J_NUM)).astype(np.float32) ** 4
    w /= w.sum(-1, keepdims=True)
    vdata = dict(diff_weight_volume=w,
                 volume_bounds=np.array([[-1, -1, -1], [1, 1, 1]],
                                        np.float32))
    jvol = JVolume(data=vdata)
    tvol = CanoBlendWeightVolume(data=vdata, device="cpu")
    params = jax.jit(JNet(_opt(True, True), jvol).init)(
        jax.random.PRNGKey(0))
    sd = template_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         params))

    sv, sf = _uv_sphere(r=0.5)
    lbs = rng.random((len(sv), J_NUM)).astype(np.float32) ** 4
    lbs /= lbs.sum(1, keepdims=True)
    mats = np.tile(np.eye(4, dtype=np.float32), (J_NUM, 1, 1))
    mats[:, :3] += 0.03 * rng.standard_normal((J_NUM, 3, 4)).astype(
        np.float32)
    hv, hf = _uv_sphere(n_theta=4, n_phi=6, r=0.12)
    items = dict(cano2live_jnt_mats=mats, live_smpl_v=sv + [0.02, 0, 0],
                 smpl_faces=sf, smpl_lbs=lbs,
                 cano_smpl_center=np.array([0, -0.3, 0], np.float32),
                 mano_face_closed=hf.astype(np.int64))
    for side, x in (("left", 0.4), ("right", -0.4)):   # SMPL left is +x
        cano = (hv + [x, 0.1, -0.35]).astype(np.float32)
        live = (cano + [0.02, 0.01, 0]).astype(np.float32)
        items.update({f"{side}_cano_mano_v": cano,
                      f"{side}_cano_mano_n": vertex_normals(cano, hf),
                      f"{side}_live_mano_v": live,
                      f"{side}_live_mano_n": vertex_normals(live, hf)})
    items = {k: np.asarray(v, np.int64 if k.endswith("faces") or
                           k == "mano_face_closed" else np.float32)
             for k, v in items.items()}

    d = rng.standard_normal((R, 3)).astype(np.float32) * 0.15
    d[:, 2] = 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = dict(ray_o=np.tile([[0.05, 0, -2.0]], (R, 1)).astype(np.float32),
                ray_d=d, near=np.full(R, 1.2, np.float32),
                far=np.full(R, 2.8, np.float32),
                dist=np.zeros(R, np.float32),
                color_gt=rng.random((R, 3)).astype(np.float32),
                mask_gt=(rng.random(R) > 0.3).astype(np.float32))
    return dict(jvol=jvol, tvol=tvol, params=params, sd=sd, items=items,
                rays=rays)


def _jax_items(s):
    return {k: jnp.asarray(v) for k, v in {**s["items"], **s["rays"]}.items()}


def _torch_items(s):
    return {k: torch.as_tensor(v) for k, v in
            {**s["items"], **s["rays"]}.items()}


def _draws(key, n_samples=S):
    """The JAX package's split of a step's key into the jitter's U(0, 1)
    and the view directions' N(0, 1), as numpy."""
    ks, kv = jax.random.split(key)
    return dict(t_rand=torch.as_tensor(np.asarray(
        jax.random.uniform(ks, (R, n_samples)))),
        view_noise=torch.as_tensor(np.asarray(
            jax.random.normal(kv, (R * n_samples, 3)))))


def _port_net(s, opt):
    net = TemplateNet(opt, s["tvol"], device="cpu")
    net.load_state_dict(s["sd"])
    return net


@pytest.mark.parametrize("with_hand,root", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_render_rays_matches_jax(setup, with_hand, root):
    """A training render (jitter, view noise, eikonal normals) with and
    without the hands and the root finding."""
    s = setup
    jnet = JNet(_opt(with_hand, root), s["jvol"])
    tnet = _port_net(s, _opt(with_hand, root))
    key = jax.random.PRNGKey(3)
    ji, ti = _jax_items(s), _torch_items(s)

    @jax.jit
    def render(p, it):
        return jnet.render_rays(p, it, it["ray_o"], it["ray_d"], it["near"],
                                it["far"], n_samples=S, training=True,
                                rng=key)

    want = render(s["params"], ji)
    got = tnet.render_rays(ti, ti["ray_o"], ti["ray_d"], ti["near"],
                           ti["far"], n_samples=S, training=True,
                           draws=_draws(key))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=ATOL_MAP,
                                   err_msg=k)
    assert float(got["acc_map"].max()) > 0.1     # the rays hit the body


def _jax_loss(jnet, p, it, key):
    """The JAX template step's loss (template_trainer.py:62-96), SMPL-guided
    near/far, for its gradients."""
    near, far = jnet.smpl_guided_near_far(it, it["ray_o"], it["ray_d"],
                                          it["near"], it["far"])
    out = jnet.render_rays(p, it, it["ray_o"], it["ray_d"], near, far,
                           n_samples=S, training=True, rng=key)
    cl = jnp.abs(out["rgb_map"] - it["color_gt"]).mean()
    ml = jnp.abs(out["acc_map"] - it["mask_gt"]).mean()
    el = ((jnp.linalg.norm(out["normal"], axis=-1) - 1.0) ** 2).mean()
    return cl + ml + 0.1 * el


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def jax_steps(setup):
    """Three updates of the JAX package's own jitted step (with hands and
    the root finding) and its step-0 gradients."""
    s = setup
    jnet = JNet(_opt(True, True), s["jvol"])
    opt = jtt.make_template_optimizer(LR)
    step = jtt.make_template_train_step(jnet, opt, loss_weight=LOSS_W,
                                        n_samples=S, smpl_guided=True)
    state = jtt.TemplateTrainState(s["params"], opt.init(s["params"]),
                                   jnp.zeros((), jnp.int32))
    ji = _jax_items(s)
    keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
    grads = jax.jit(jax.grad(lambda p: _jax_loss(jnet, p, ji, keys[0])))(
        s["params"])
    terms, params = [], []
    for k in keys:
        state, t = step(state, ji, k)
        terms.append({n: float(v) for n, v in t.items()})
        params.append(state.params)
    return dict(keys=keys, grads=grads, terms=terms, params=params,
                jnet=jnet)


def test_template_step_matches_jax(setup, jax_steps):
    """Three Adam updates of the port's step from the same parameters on
    the same rays with the JAX draws: each step's loss terms, step 0's
    gradients per group and the parameters after the first update."""
    s, js = setup, jax_steps
    net = _port_net(s, _opt(True, True))
    optimizer, scheduler = tt.make_template_optimizer(net, LR)
    step = tt.TemplateStep(net, optimizer, scheduler, loss_weight=LOSS_W,
                           n_samples=S, smpl_guided=True)
    ti = _torch_items(s)
    for i, key in enumerate(js["keys"]):
        if i == 0:
            total, _ = step.loss(ti, draws=_draws(key))
            total.backward()
            want = template_params_from_jax(jax.tree_util.tree_map(
                np.asarray, js["grads"]))
            got = {n: p.grad for n, p in net.named_parameters()}
            for g in GROUPS:
                keys = [k for k in want if k.startswith(g + ".")]
                a = torch.cat([got[k].reshape(-1) for k in keys]).numpy()
                b = torch.cat([want[k].reshape(-1) for k in keys]).numpy()
                assert _rel(a, b) < RTOL_GRAD, g
        terms = step(ti, draws=_draws(key))
        assert set(terms) == set(js["terms"][i])
        for k, v in js["terms"][i].items():
            rtol = RTOL_LOSS if i == 0 else RTOL_LOSS_LATER
            assert float(terms[k]) == pytest.approx(v, rel=rtol), (i, k)
        if i == 0:
            want = template_params_from_jax(jax.tree_util.tree_map(
                np.asarray, js["params"][0]))
            for k, v in net.state_dict().items():
                np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                           atol=ATOL_PARAM, err_msg=k)
    # the next update's rate: 5e-4 x 0.9^(3 // 2), above the floor
    assert optimizer.param_groups[0]["lr"] == pytest.approx(4.5e-4)


def test_finetune_hand_moves_only_the_hands(setup, jax_steps):
    """With finetune_hand only left_hand / right_hand move, by the JAX
    package's multi_transform Adam applied to the JAX gradients; every
    other group keeps its value."""
    s, js = setup, jax_steps
    net = _port_net(s, _opt(True, True))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    optimizer, scheduler = tt.make_template_optimizer(net, LR,
                                                      finetune_hand=True)
    step = tt.TemplateStep(net, optimizer, scheduler, loss_weight=LOSS_W,
                           n_samples=S, smpl_guided=True)
    step(_torch_items(s), draws=_draws(js["keys"][0]))
    jopt = jtt.make_template_optimizer(LR, finetune_hand=True)
    upd, _ = jopt.update(js["grads"], jopt.init(s["params"]), s["params"])
    want = template_params_from_jax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(s["params"], upd)))
    for k, v in net.state_dict().items():
        if k.startswith(("left_hand.", "right_hand.")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       atol=ATOL_PARAM, err_msg=k)
        else:
            assert torch.equal(v, before[k]), k
    moved = [k for k in before if not torch.equal(net.state_dict()[k],
                                                  before[k])]
    assert moved and all(k.startswith(("left_hand.", "right_hand."))
                         for k in moved)


def test_test_geometry_matches_jax(setup, tmp_path):
    """The export at a small grid: the same mesh as the JAX package's
    test_geometry, and a readable PLY."""
    s = setup
    jnet = JNet(_opt(True, True), s["jvol"])
    tnet = _port_net(s, _opt(True, True))
    bounds = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    vj, fj, nj = jtt.test_geometry(jnet, s["params"],
                                   dict(cano_bounds=bounds), space="cano",
                                   testing_res=(12, 13, 11), chunk=512)
    timings = {}
    vt, ft, nt = tt.test_geometry(tnet, dict(cano_bounds=bounds),
                                  space="cano", testing_res=(12, 13, 11),
                                  chunk=500, timings=timings)
    assert len(ft) > 50 and set(timings) == {"sdf_s", "mcubes_s"}
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, atol=1e-5)
    np.testing.assert_allclose(nt, nj, atol=1e-4)
    path = str(tmp_path / "template.ply")
    tt.save_mesh_as_ply(path, vt, ft, nt)
    from animatablegaussians_torch.utils.ply import read_ply
    props, faces = read_ply(path)
    np.testing.assert_array_equal(faces, ft)
    np.testing.assert_array_equal(props["nx"], nt[:, 0].astype(np.float32))
