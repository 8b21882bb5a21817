"""The evaluation slice of the port (``animatablegaussians_torch/eval``)
against the JAX package's ``eval/`` on the CPU, with the same numpy inputs
from a seed.

Tolerances: PSNR and SSIM 1e-10 relative (float64 both; the box means sum
in another order than scipy's running filter); ``crop_image`` bit for bit
(the same cv2 call); LPIPS 1e-5 absolute (float32 VGG convolutions of two
frameworks); the resize to 299 1e-5 absolute (antialiased bilinear both);
the Inception trunk's pool3 features 1e-4 of the largest feature (float32
through ~100 convolutions); the folded weights bit for bit (both fold in
float64 and round once); ``frechet_distance`` 1e-8 relative (float64
eigendecompositions of two LAPACK drivers); a directory FID 1e-4 relative
(it carries the features' float32 differences).

One JAX Inception trunk is built in this file, from a synthetic
torchvision-layout state dict through ``from_torch`` (the JAX package's
``init_random`` draws its 94 weights eagerly, one compile each).

Marked ``gpu`` (skipped without a CUDA device): a full-width capture
(on_card.write_capture) rendered from each of its 2 cameras by
``main_avatar_torch -m test`` with the position and other heads' outputs
zeroed (1500x2048 JPEGs, each covering at least ANIM_COVER_MIN of its
frame), then scored through the evaluation CLI's functions on the card
(compare_methods at 512^2 crops, LPIPS with random VGG16 weights,
compute_fid with a random Inception trunk: not valid metrics) with no
kernel of the port launched: each PSNR against numpy's, the card against
the CPU (PSNR, SSIM, LPIPS, the features, the Fréchet distance and the
FID, beside a planted fault), and one Inception batch's kernels summed
from a ``utils/profiling.trace`` against its CUDA-event time.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animatablegaussians_tpu.eval import comparison as jcmp
from animatablegaussians_tpu.eval import fid as jfid
from animatablegaussians_tpu.eval import score as jscore
from animatablegaussians_torch.eval import comparison as tcmp
from animatablegaussians_torch.eval import fid as tfid
from animatablegaussians_torch.eval import score as tscore
from animatablegaussians_torch.training import lpips as tlp
from animatablegaussians_torch.utils.convert import (inception_from_jax,
                                                     lpips_from_jax)
from on_card import (ANIM_COVER_MIN, DRIVER_FRAMES, card,  # noqa: F401
                     kernels, launches, render_checkpoint, reset_launches,
                     write_capture, write_config)

cv = pytest.importorskip("cv2")

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RTOL_F64 = 1e-10
ATOL_LPIPS = 1e-5
ATOL_RESIZE = 1e-5
RTOL_FEATURES = 1e-4
RTOL_FRECHET = 1e-8
RTOL_FID = 1e-4


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _lpips_params(seed=0):
    """JAX-layout LPIPS weights made with numpy (HWIO convolutions, the
    JAX init's scales) and the port's state dict carried across."""
    rng = np.random.default_rng(seed)
    convs, cin = [], 3
    for c in tlp.VGG16_CFG:
        if c == "M":
            continue
        w = rng.standard_normal((3, 3, cin, c)) / np.sqrt(9 * cin)
        convs.append(dict(weight=w.astype(np.float32),
                          bias=(0.01 * rng.standard_normal(c)).astype(
                              np.float32)))
        cin = c
    lins = [(np.abs(rng.standard_normal(c)) / c).astype(np.float32)
            for c in tlp.LIN_CHANNELS]
    jp = dict(convs=[{k: jnp.asarray(v) for k, v in c.items()}
                     for c in convs], lins=[jnp.asarray(l) for l in lins])
    return jp, lpips_from_jax(dict(convs=convs, lins=lins))


def _torchvision_state(seed=0):
    """A torchvision ``inception_v3``-layout state dict: conv weights and
    BatchNorm tensors with random running statistics per conv, plus the
    ``fc`` and ``AuxLogits`` keys that the loaders drop."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def need(name, kh, kw, cin, cout):
        sd[f"{name}.conv.weight"] = torch.randn(
            (cout, cin, kh, kw), generator=g) * (2.0 / (kh * kw * cin)) ** 0.5
        sd[f"{name}.bn.weight"] = 0.8 + 0.4 * torch.rand(cout, generator=g)
        sd[f"{name}.bn.bias"] = 0.1 * torch.randn(cout, generator=g)
        sd[f"{name}.bn.running_mean"] = 0.1 * torch.randn(cout, generator=g)
        sd[f"{name}.bn.running_var"] = 0.5 + torch.rand(cout, generator=g)
        sd[f"{name}.bn.num_batches_tracked"] = torch.tensor(7)

    jfid._build_shapes(need)
    sd["AuxLogits.conv0.conv.weight"] = torch.randn((128, 768, 1, 1),
                                                    generator=g)
    sd["AuxLogits.fc.weight"] = torch.randn((1000, 768), generator=g)
    sd["fc.weight"] = torch.randn((1000, 2048), generator=g)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


@pytest.fixture
def one_thread():
    """One thread for torch and the BLAS libraries during a test. Where
    several test processes share the cores, a float64 eigendecomposition
    at 2048 dimensions with a thread a core took 75-208 s instead of a
    few seconds: its many small parallel regions wait on threads the
    other processes hold."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trunk(tmp_path_factory):
    """One Inception trunk in both packages, from the same torchvision
    state dict file; the JAX features jitted once, for 2 images."""
    path = str(tmp_path_factory.mktemp("inception") / "inception_v3.pth")
    torch.save(_torchvision_state(), path)
    jm = jfid.InceptionV3Features.from_torch(path)
    tm = tfid.InceptionV3Features.from_torch(path, device="cpu")
    return dict(path=path, jax=jm, torch=tm,
                jax_features=jax.jit(jm.features))


def test_psnr_and_ssim_match_jax():
    """Full frames (64x80x3 and one channel), and pairs that differ only
    within 3 pixels of the border, where the kept windows touch it."""
    rng = np.random.default_rng(0)
    a = rng.random((64, 80, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    border = a.copy()
    border[:3] = rng.random((3, 80, 3))
    border[-3:] = rng.random((3, 80, 3))
    border[:, :3] = rng.random((64, 3, 3))
    border[:, -3:] = rng.random((64, 3, 3))
    for x, y in ((a, b), (a, border), (a[..., 0], b[..., 0]),
                 (a[..., 1], border[..., 1])):
        for name in ("compute_psnr", "compute_ssim"):
            want = getattr(jscore, name)(x, y)
            got = getattr(tscore, name)(x, y, device="cpu")
            assert _rel(got, want) <= RTOL_F64, (name, x.shape, got, want)
    assert tscore.compute_ssim(a, border, device="cpu") < 1.0
    assert tscore.compute_psnr(a, a, device="cpu") == float("inf")


def test_crop_image_bit_for_bit():
    rng = np.random.default_rng(1)
    for (h, w), box in (((120, 90), (30, 70, 20, 40)),
                        ((90, 120), (10, 30, 5, 110)),
                        ((200, 160), (60, 180, 50, 150))):
        mask = np.zeros((h, w), bool)
        mask[box[0]:box[1], box[2]:box[3]] = True
        img = rng.random((h, w, 3)).astype(np.float32)
        img2 = rng.random((h, w, 3)).astype(np.float32)
        for patch in (32, 64):
            want = jscore.crop_image(mask, patch, img, None, img2)
            got = tscore.crop_image(mask, patch, img, None, img2)
            assert got[1] is None
            for g, wv in zip((got[0], got[2]), (want[0], want[2])):
                assert g.shape == (patch, patch, 3)
                assert np.array_equal(g, wv)


def test_lpips_matches_jax_on_a_non_square_pair():
    rng = np.random.default_rng(2)
    a = rng.random((40, 56, 3)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    jp, sd = _lpips_params()
    want = jscore.compute_lpips(a, b, lpips_params=jp)
    got = tscore.compute_lpips(a, b, lpips_params=sd, device="cpu")
    assert abs(got - want) <= ATOL_LPIPS, (got, want)
    net = tlp.LPIPS(sd, device="cpu")
    assert tscore.compute_lpips(a, b, lpips_params=net) == got
    assert tscore.compute_lpips(a, a, lpips_params=net) == 0.0


@pytest.mark.parametrize("size", [(64, 48), (512, 400)])
def test_resize_to_299_matches_jax(size):
    """Up- and downsampling: ``jax.image.resize``'s bilinear antialiases
    when it shrinks, and so must the port's (without, the two differ by
    more than 0.1 there)."""
    x = np.random.default_rng(3).random((2, *size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (2, 299, 299, 3), "bilinear"))
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tfid.resize_299(t)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=ATOL_RESIZE)
    if size[0] > 299:
        plain = torch.nn.functional.interpolate(
            t, size=(299, 299), mode="bilinear", align_corners=False)
        assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 0.1


def test_pools_exclude_padding_like_jax():
    """The blocks' 3x3 average divides by the pixels inside the image, as
    the JAX trunk's; the stride-2 max pools have no padding."""
    x = np.random.default_rng(4).standard_normal((1, 9, 11, 5)).astype(
        np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    for want, got in (
            (jfid._pool(jnp.asarray(x), 3, 1, 1, "avg"), tfid._avg3(t)),
            (jfid._pool(jnp.asarray(x), 3, 2, 0, "max"), tfid._max3s2(t))):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-6)


def test_inception_features_match_jax(trunk):
    """pool3 features of 2 images through both trunks; the port's folded
    weights equal the JAX package's carried across."""
    jparams = {k: {n: np.asarray(v) for n, v in p.items()}
               for k, p in trunk["jax"].params.items()}
    sd = trunk["torch"].state_dict()
    carried = inception_from_jax(jparams)
    assert set(carried) == set(sd) and len(sd) == 2 * 94
    for k, v in carried.items():
        assert torch.equal(v, sd[k]), k

    x = np.random.default_rng(5).random((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(trunk["jax_features"](x))
    got = trunk["torch"].features(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= RTOL_FEATURES, err
    assert np.isfinite(got).all() and np.abs(got).max() > 0


def test_init_random_has_the_trunk_shapes():
    """He-normal weights at every conv of the JAX trunk's ``_build_shapes``
    (HWIO there, (out, in, kh, kw) here), reproducible from the
    generator's seed."""
    shapes = {}
    jfid._build_shapes(lambda n, kh, kw, cin, cout: shapes.__setitem__(
        n, (cout, cin, kh, kw)))
    m = tfid.InceptionV3Features.init_random(
        torch.Generator().manual_seed(0), device="cpu")
    sd = m.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()
            if k.endswith(".weight")} == {f"{n}.weight": s
                                          for n, s in shapes.items()}
    w = sd["Mixed_7c.branch3x3dbl_1.weight"]
    assert abs(float(w.std()) - (2.0 / 2048) ** 0.5) < 1e-3
    again = tfid.InceptionV3Features.init_random(
        torch.Generator().manual_seed(0), device="cpu").state_dict()
    assert all(torch.equal(v, again[k]) for k, v in sd.items())


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(6)
    for n, d in ((200, 32), (10, 48)):           # full rank, rank-deficient
        f1 = rng.standard_normal((n, d))
        f2 = 0.5 + 1.5 * rng.standard_normal((n, d))
        js = [jfid.gaussian_stats(f) for f in (f1, f2)]
        ts = [tfid.gaussian_stats(f, device="cpu") for f in (f1, f2)]
        for (jm, jc), (tm, tc) in zip(js, ts):
            np.testing.assert_allclose(tm.numpy(), jm, rtol=1e-12,
                                       atol=1e-14)
            np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-12,
                                       atol=1e-14)
        want = jfid.frechet_distance(*js[0], *js[1])
        got = tfid.frechet_distance(*ts[0], *ts[1], device="cpu")
        assert _rel(got, want) <= RTOL_FRECHET, (n, d, got, want)
        assert tfid.frechet_distance(*ts[0], *ts[0], device="cpu") < 1e-6


def _write_comparison_fixture(root):
    """The 64x64 frames, masks and a noisy method that
    ``tests/test_misc_coverage.py::test_comparison_driver`` writes."""
    rng = np.random.default_rng(1)
    gt_dir, mask_dir, m_dir = (os.path.join(root, n)
                               for n in ("gt", "mask", "ours"))
    for d in (gt_dir, mask_dir, m_dir):
        os.makedirs(d)
    for f in (0, 1):
        mask = np.zeros((64, 64), np.uint8)
        mask[10:50, 15:45] = 255
        img = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
        img[mask == 0] = 255
        cv.imwrite(os.path.join(gt_dir, "%08d.jpg" % f), img)
        noisy = np.clip(img.astype(int)
                        + rng.integers(-10, 10, img.shape), 0,
                        255).astype(np.uint8)
        noisy[mask == 0] = 255
        cv.imwrite(os.path.join(m_dir, "%08d.jpg" % f), noisy)
        cv.imwrite(os.path.join(mask_dir, "%08d.jpg" % f), mask)
    return gt_dir, mask_dir, m_dir


def test_compare_methods_matches_jax(tmp_path):
    gt_dir, mask_dir, m_dir = _write_comparison_fixture(str(tmp_path))
    jp, sd = _lpips_params()
    want = jcmp.compare_methods(dict(ours=m_dir), gt_dir, mask_dir, [0, 1],
                                patch_size=32, lpips_params=jp,
                                crop_out_dir=str(tmp_path / "jcrops"))
    got = tcmp.compare_methods(dict(ours=m_dir), gt_dir, mask_dir, [0, 1],
                               patch_size=32, lpips_params=sd,
                               crop_out_dir=str(tmp_path / "tcrops"),
                               device="cpu")
    w, g = want["ours"], got["ours"]
    assert g.count == w.count == 2
    assert _rel(g.psnr, w.psnr) <= RTOL_F64
    assert _rel(g.ssim, w.ssim) <= RTOL_F64
    assert abs(g.lpips - w.lpips) <= 2 * ATOL_LPIPS
    assert 10 < g.psnr / g.count < 50
    for sub in ("gt", "ours"):
        for f in ("00000000.png", "00000001.png"):
            a = cv.imread(str(tmp_path / "jcrops" / sub / f))
            b = cv.imread(str(tmp_path / "tcrops" / sub / f))
            assert a is not None and np.array_equal(a, b), (sub, f)


def test_compute_fid_matches_jax(trunk, tmp_path, one_thread):
    """3 + 3 images of 64^2 through both packages' directory FID."""
    rng = np.random.default_rng(7)
    dirs = [str(tmp_path / n) for n in ("a", "b")]
    for i, d in enumerate(dirs):
        os.makedirs(d)
        for k in range(3):
            img = (rng.random((64, 64, 3)) * (200 + 55 * i)).astype(np.uint8)
            cv.imwrite(os.path.join(d, "%08d.png" % k), img)
    want = jfid.compute_fid(*dirs, trunk["jax"])
    got = tfid.compute_fid(*dirs, trunk["torch"])
    assert np.isfinite(got) and got > 0
    assert _rel(got, want) <= RTOL_FID, (got, want)


def test_cli_runs_on_the_card_unless_told(tmp_path, monkeypatch, capsys):
    """Without a card the CLI raises unless ``--device cpu`` is given;
    with it, it turns TF32 off, says so and scores like
    ``compare_methods``."""
    gt_dir, mask_dir, m_dir = _write_comparison_fixture(str(tmp_path))
    argv = ["--gt_dir", gt_dir, "--mask_dir", mask_dir,
            "--method", f"ours={m_dir}", "--frames", "1", "2",
            "--crop_out_dir", str(tmp_path / "crops")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcmp.main(argv)
    torch.backends.cudnn.allow_tf32 = True
    try:
        out = tcmp.main(argv + ["--device", "cpu"])
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    text = capsys.readouterr().out
    assert "TF32: off" in text and "ours metrics: Count: 1" in text
    want = tcmp.compare_methods(dict(ours=m_dir), gt_dir, mask_dir, [1],
                                device="cpu")
    assert out["ours"].psnr == want["ours"].psnr
    assert out["ours"].lpips == want["ours"].lpips
    assert os.path.exists(tmp_path / "crops" / "gt" / "00000001.png")


# ---------------------------------------------------------------------------
# on the card, at full width
# ---------------------------------------------------------------------------

# the capture rendered from its own cameras (in calibration order,
# tools/capture_fixture.write_capture's names) and scored at the reference
# protocol's 512^2 crops; the Inception trunk's batch
EVAL_CAMS, EVAL_PATCH, EVAL_BATCH = ("cam00", "cam01"), 512, 8
# the card against the CPU on the same frames: PSNR and SSIM relative
# (float64 on both devices, sums in another order); LPIPS absolute (float32
# VGG16 convolutions of cuDNN and the CPU, TF32 off); the Inception
# features relative to the largest feature (float32 through 94
# convolutions); the Fréchet distance of the same float64 statistics
# relative (two eigensolvers: cuSOLVER's and LAPACK's)
EVAL_RTOL_F64, EVAL_ATOL_LPIPS = 1e-9, 1e-4
EVAL_RTOL_FEATURES, EVAL_RTOL_FRECHET = 1e-4, 1e-6
# the FID end to end, each device's features through its own statistics
# and distance, relative. The two devices' float32 convolutions put the
# features 1.0e-6 to 1.1e-6 apart (relative to the largest feature), and
# the distance carries that at 1.7e-6 to 2.2e-6 (H100, three runs), so
# 1e-6 cannot hold here; the limit is about 5 times the largest reading.
# A planted fault, the crops resized without antialiasing (the trap of
# fid.resize_299), must move the FID by more than EVAL_FAULT_MIN times it
EVAL_RTOL_FID, EVAL_FAULT_MIN = 1e-5, 10
# one Inception batch's kernels summed from a torch.profiler trace
# (utils/profiling.trace_report) over the batch's CUDA-event time: the
# kernels cannot take longer than the span that holds them (up to the two
# clocks' noise), and the launch gaps between them are a small share
EVAL_TRACE_SHARE = (0.5, 1.1)


@pytest.fixture(scope="module")
def scored(card, tmp_path_factory):
    """The capture's frames rendered from each camera, then scored on the
    card: the renders' kernel launches, the scores, the FID and the
    scorer's launches."""
    import main_avatar_torch
    tmp = str(tmp_path_factory.mktemp("eval"))
    opt = write_capture(tmp)
    ckpt = render_checkpoint(opt, os.path.join(tmp, "render_ckpt"), card)
    data = opt["train"]["data"]
    reset_launches(*kernels())
    renders = {}
    for i, cam in enumerate(EVAL_CAMS):
        test = dict(data=dict(data_dir=data["data_dir"],
                              frame_range=[0, DRIVER_FRAMES],
                              smpl_model_path=data["smpl_model_path"]),
                    view_setting="camera", render_view_idx=i,
                    img_scale=1.0, prev_ckpt=ckpt,
                    output_dir=os.path.join(tmp, f"eval_{cam}"))
        cfg = write_config(dict(opt, test=test),
                           os.path.join(tmp, f"eval_{cam}.yaml"))
        main_avatar_torch.main(["-c", cfg, "-m", "test"], device=str(card))
        renders[cam] = os.path.join(test["output_dir"], "rgb_map")
    render_launches = launches(*kernels())

    def score(device, lp, crops=None):
        """Per-frame [psnr, ssim, lpips] of every camera and frame."""
        out = {}
        for cam in EVAL_CAMS:
            for f in range(DRIVER_FRAMES):
                m = tcmp.compare_methods(
                    {"ours": renders[cam]},
                    os.path.join(data["data_dir"], cam),
                    os.path.join(data["data_dir"], cam, "mask", "pha"), [f],
                    patch_size=EVAL_PATCH, lpips_params=lp,
                    crop_out_dir=crops and os.path.join(crops, cam),
                    device=device)["ours"]
                assert m.count == 1, (cam, f)
                out[(cam, f)] = [m.psnr, m.ssim, m.lpips]
        return out

    lp_weights = tlp.init_random(0)
    crops = os.path.join(tmp, "eval_crops")
    reset_launches(*kernels())
    card_scores = score(str(card), tlp.LPIPS(lp_weights, device=card),
                        crops)
    # the FID's directories: both cameras' crops
    fid_dirs = {}
    for sub in ("ours", "gt"):
        fid_dirs[sub] = os.path.join(crops, "all", sub)
        os.makedirs(fid_dirs[sub])
        for cam in EVAL_CAMS:
            for name in os.listdir(os.path.join(crops, cam, sub)):
                shutil.copy(os.path.join(crops, cam, sub, name),
                            os.path.join(fid_dirs[sub], f"{cam}_{name}"))
    inception = tfid.InceptionV3Features.init_random(
        torch.Generator().manual_seed(18), device=card)
    fid_card = tfid.compute_fid(fid_dirs["ours"], fid_dirs["gt"], inception,
                                batch=EVAL_BATCH)
    return dict(tmp=tmp, data=data, renders=renders, crops=crops,
                render_launches=render_launches,
                score_launches=launches(*kernels()), score=score,
                lp_weights=lp_weights, card_scores=card_scores,
                fid_dirs=fid_dirs, inception=inception, fid_card=fid_card)


@pytest.mark.gpu
def test_renders_from_the_captures_cameras(scored):
    import cv2

    from animatablegaussians_torch.tools import capture_fixture as cf
    n = len(EVAL_CAMS) * DRIVER_FRAMES
    r = scored["render_launches"]
    assert r["expand_pairs"] == r["blend_tiles"] == n
    assert r["blend_backward"] == 0 and r["upfirdn2d_fir"] > 0
    cover = []
    for cam, d in scored["renders"].items():
        for f in range(DRIVER_FRAMES):
            img = cv2.imread(os.path.join(d, "%08d.jpg" % f))
            assert img is not None, (cam, f)
            assert img.shape == (cf.FULL["img_h"], cf.FULL["img_w"], 3)
            # the share of pixels with alpha >= 1/255 (run_test's mask_map
            # PNG holds floor(255 alpha))
            cover.append(float((cv2.imread(os.path.join(
                os.path.dirname(d), "mask_map", "%08d.png" % f),
                cv2.IMREAD_UNCHANGED) >= 1).mean()))
    print(f"pixels with alpha >= 1/255: {min(cover):.4f} to "
          f"{max(cover):.4f} of a frame")
    assert min(cover) >= ANIM_COVER_MIN, cover


@pytest.mark.gpu
def test_scores_on_the_card_are_the_frames_own(scored):
    """No kernel of the port launches while scoring; each frame's PSNR
    equals numpy's on the same pairing and differs against the other
    camera's frame; the crops are 512^2."""
    import cv2
    assert not any(scored["score_launches"].values()), \
        scored["score_launches"]
    scores, data = scored["card_scores"], scored["data"]
    assert all(np.isfinite(x) for v in scores.values() for x in v)
    assert np.isfinite(scored["fid_card"])

    def plain_psnr(render, cam, f):
        """numpy's PSNR of a render against camera ``cam``'s frame ``f``,
        whitened outside its matte, read as compare_methods reads them."""
        def rd(path):
            img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            return (img / 255.0).astype(np.float32).astype(np.float64)
        gt = rd(os.path.join(data["data_dir"], cam, "%08d.jpg" % f))
        mask = rd(os.path.join(data["data_dir"], cam, "mask", "pha",
                               "%08d.jpg" % f)) > 0.5
        gt[~(mask[..., 0] if mask.ndim == 3 else mask)] = 1.0
        return float(10.0 * np.log10(1.0 / np.mean((rd(render) - gt) ** 2)))

    psnr_err, swap_gap = 0.0, np.inf
    for (cam, f), v in scores.items():
        other = EVAL_CAMS[1 - EVAL_CAMS.index(cam)]
        render = os.path.join(scored["renders"][cam], "%08d.jpg" % f)
        right = plain_psnr(render, cam, f)
        psnr_err = max(psnr_err, abs(v[0] - right) / right)
        swap_gap = min(swap_gap,
                       abs(v[0] - plain_psnr(render, other, f)) / right)
    assert psnr_err <= EVAL_RTOL_F64, psnr_err
    assert swap_gap > 1e3 * EVAL_RTOL_F64, swap_gap
    assert len({v[0] for v in scores.values()}) > 1
    for cam in EVAL_CAMS:
        for sub in ("ours", "gt"):
            for f in range(DRIVER_FRAMES):
                c = cv2.imread(os.path.join(scored["crops"], cam, sub,
                                            "%08d.png" % f))
                assert c is not None
                assert c.shape == (EVAL_PATCH, EVAL_PATCH, 3), (cam, sub, f)


@pytest.mark.gpu
def test_scores_on_the_card_against_the_cpu(card, scored):
    """The same frames, weights and features scored on the CPU, and a
    planted fault: the renders' crops resized to 299 without antialiasing,
    through the same trunk on the card."""
    import torch.nn.functional as F
    card_scores = scored["card_scores"]
    cpu_scores = scored["score"]("cpu", tlp.LPIPS(scored["lp_weights"],
                                                  device="cpu"))
    errs = [max(abs(card_scores[k][i] - cpu_scores[k][i])
                / (abs(cpu_scores[k][i]) if i < 2 else 1.0)
                for k in card_scores) for i in range(3)]
    inception, fid_card = scored["inception"], scored["fid_card"]
    inception_cpu = tfid.InceptionV3Features.init_random(
        torch.Generator().manual_seed(18), device="cpu")
    feats, feat_err = {}, 0.0
    for sub, d in scored["fid_dirs"].items():
        a = tfid.features_of_images(inception, tfid.read_rgb_dir(d),
                                    EVAL_BATCH)
        b = tfid.features_of_images(inception_cpu, tfid.read_rgb_dir(d),
                                    EVAL_BATCH)
        feat_err = max(feat_err, float((a.cpu() - b).abs().max()
                                       / b.abs().max()))
        feats[sub] = (a, b)
    stats = {sub: tfid.gaussian_stats(a, card) for sub, (a, _) in
             feats.items()}
    fd_card = tfid.frechet_distance(*stats["ours"], *stats["gt"],
                                    device=card)
    fd_cpu = tfid.frechet_distance(*stats["ours"], *stats["gt"],
                                   device="cpu")
    fd_cpu_feats = tfid.frechet_distance(
        *tfid.gaussian_stats(feats["ours"][1], "cpu"),
        *tfid.gaussian_stats(feats["gt"][1], "cpu"), device="cpu")
    with torch.no_grad():
        x = torch.from_numpy(np.stack(list(tfid.read_rgb_dir(
            scored["fid_dirs"]["ours"])))).float().to(card)
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299),
                          mode="bilinear", align_corners=False)
        fault = inception.trunk(x * 2.0 - 1.0)
    fd_fault = tfid.frechet_distance(*tfid.gaussian_stats(fault, card),
                                     *stats["gt"], device=card)
    fid_rel = abs(fd_cpu_feats - fid_card) / fid_card
    fault_rel = abs(fd_fault - fid_card) / fid_card
    print(f"PSNR, SSIM, LPIPS {errs}; features {feat_err:.2e}; Fréchet "
          f"card {fd_card:.9f} CPU {fd_cpu:.9f}; FID card {fid_card:.9f} "
          f"CPU {fd_cpu_feats:.9f} ({fid_rel:.2e}); fault {fault_rel:.2e}")
    assert errs[0] <= EVAL_RTOL_F64 and errs[1] <= EVAL_RTOL_F64, errs
    assert errs[2] <= EVAL_ATOL_LPIPS, errs
    assert feat_err <= EVAL_RTOL_FEATURES, feat_err
    assert abs(fd_card - fd_cpu) / abs(fd_cpu) <= EVAL_RTOL_FRECHET
    assert abs(fd_card - fid_card) <= EVAL_RTOL_FRECHET * fid_card
    assert fid_rel <= EVAL_RTOL_FID, fid_rel
    assert fault_rel > EVAL_FAULT_MIN * EVAL_RTOL_FID, fault_rel


@pytest.mark.gpu
def test_trace_report_sums_an_inception_batch(card, scored):
    """One Inception batch under ``utils/profiling.trace``: its kernels,
    summed by ``trace_report``, come to EVAL_TRACE_SHARE of the batch's
    CUDA-event time, with convolutions among them (cuDNN's implicit-GEMM,
    Winograd and FFT kernels, by name)."""
    import re

    from animatablegaussians_torch.utils import profiling
    inception = scored["inception"]
    rng = np.random.default_rng(18)
    batch = torch.from_numpy(rng.random((EVAL_BATCH, 512, 512, 3),
                                        dtype=np.float32)).to(card)
    for _ in range(2):                                  # warm-up
        inception.features(batch)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(8):
        inception.features(batch)
    ev[1].record()
    torch.cuda.synchronize()
    batch_ms = ev[0].elapsed_time(ev[1]) / 8
    d = os.path.join(scored["tmp"], "eval_trace")
    with profiling.trace(d):
        profiling.sync(inception.features(batch))
    report = profiling.trace_report(d, top=10 ** 6)
    assert not report.startswith("no "), report
    rows = [ln.split(None, 4) for ln in report.splitlines()]
    total = sum(float(r[0]) for r in rows)
    conv = sum(float(r[0]) for r in rows if re.search(
        r"conv|fprop|xmma|implicit_gemm|cudnn|winograd|fft", r[4], re.I))
    print(f"trace_report {total:.3f} ms of {batch_ms:.3f} ms of CUDA "
          f"events, convolutions {conv:.3f} ms")
    assert EVAL_TRACE_SHARE[0] <= total / batch_ms <= EVAL_TRACE_SHARE[1]
    assert conv > 0
