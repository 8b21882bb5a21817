"""The port's loader-fed train path (``data/native_io.py``, the batched
decode of ``native/dataloader.cpp``, ``tools/bench_loader.py``,
``utils/synthetic.batch_items``, ``utils/exr.imread`` / ``imwrite``)
against the JAX package's on the CPU, with the same files and numpy
inputs.

Tolerances: every decode bit for bit (where both packages build their
libjpeg cores, the two are the same libjpeg code, and the batch decodes
each file with the one-file routine); the datasets' files byte for byte (both write
with cv2 and the same EXR codec) and their items bit for bit; the timed
loop's loss terms finite (the loop itself is checked for its step count,
its waits and its readings; its numbers are the train step's, which
``tests/test_torch_train.py`` holds against JAX).

Marked ``gpu`` (skipped without a CUDA device): ``tools/bench_loader``'s
loop on LOADER_FRAMES frames at 1500x2048, at B = 1 and B = 2 with
LOADER_THREADS decode threads (the first batch on the card equal to
``DiskDataset``'s read bit for bit, the train step's kernel launches a
step, finite losses, over steps that cross an epoch's end), and DECODE_FILES JPEGs at 1500x2048 through
``decode_jpeg_batch`` at 1 and LOADER_THREADS threads against
``decode_jpeg``, bit for bit, with that machine's codec.
"""

import os

import numpy as np
import pytest
import torch

from animatablegaussians_tpu.data import native_io as jnio
from animatablegaussians_tpu.tools import bench_loader as jbl
from animatablegaussians_tpu.utils import exr as jexr
from animatablegaussians_tpu.utils import synthetic as jsyn
from animatablegaussians_torch.data import image_io, native_io
from animatablegaussians_torch.data.loader import PrefetchLoader
from animatablegaussians_torch.tools import bench_loader as tbl
from animatablegaussians_torch.utils import exr as texr
from animatablegaussians_torch.utils import synthetic as tsyn
from on_card import (card, fir_count, full_width, kernels,  # noqa: F401
                     launches, reset_launches, train_kw)

cv = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def jpgs(tmp_path_factory):
    """Four colour JPEGs of 40x56, one grayscale, one of another size."""
    d = tmp_path_factory.mktemp("jpgs")
    rng = np.random.default_rng(0)
    base = cv.GaussianBlur((rng.random((40, 56, 3)) * 255).astype(np.uint8),
                           (5, 5), 2)
    paths = []
    for i in range(4):
        p = str(d / f"c{i}.jpg")
        cv.imwrite(p, np.roll(base, 3 * i, axis=1),
                   [cv.IMWRITE_JPEG_QUALITY, 90])
        paths.append(p)
    gray = str(d / "g.jpg")
    cv.imwrite(gray, base[..., 1])
    other = str(d / "other.jpg")
    cv.imwrite(other, base[:32])
    return dict(color=paths, gray=gray, other=other)


def test_codec_is_libjpeg_on_both_sides():
    """The bit-for-bit cases below hold two libjpeg decoders to each
    other; with cv2 they would compare cv2 with itself."""
    assert image_io.CODEC == "libjpeg"
    assert jnio.load_native() is not None


def test_jpeg_info_and_decode_match_jax(jpgs):
    for p in jpgs["color"] + [jpgs["gray"], jpgs["other"]]:
        assert native_io.jpeg_info(p) == jnio.jpeg_info(p)
        for gray in (False, True):
            got = native_io.decode_jpeg(p, grayscale=gray)
            want = jnio.decode_jpeg(p, grayscale=gray)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    # a colour file read one way and the other agrees with the data path
    np.testing.assert_array_equal(native_io.decode_jpeg(jpgs["color"][0]),
                                  image_io.read_jpeg(jpgs["color"][0]))


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_decode_batch_matches_jax(jpgs, n_threads):
    paths = jpgs["color"]
    got = native_io.decode_jpeg_batch(paths, n_threads=n_threads)
    want = jnio.decode_jpeg_batch(paths, n_threads=n_threads)
    assert got.shape == (4, 40, 56, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.stack([native_io.decode_jpeg(p) for p in paths]))
    gray = native_io.decode_jpeg_batch(paths, grayscale=True,
                                       n_threads=n_threads)
    np.testing.assert_array_equal(
        gray, jnio.decode_jpeg_batch(paths, grayscale=True,
                                     n_threads=n_threads))


def test_decode_batch_refuses_mixed_sizes_and_missing_files(jpgs, tmp_path):
    with pytest.raises(ValueError):
        native_io.decode_jpeg_batch(jpgs["color"] + [jpgs["other"]])
    with pytest.raises(ValueError):
        native_io.decode_jpeg_batch([])
    with pytest.raises(FileNotFoundError):
        native_io.decode_jpeg_batch([str(tmp_path / "none.jpg")])
    # a truncated file reads its header but fails to decode
    bad = str(tmp_path / "bad.jpg")
    with open(jpgs["color"][0], "rb") as f:
        data = f.read()
    with open(bad, "wb") as f:
        f.write(data[:len(data) // 3])
    with pytest.raises(IOError):
        native_io.decode_jpeg_batch([jpgs["color"][0], bad])


def test_boundary_mask_matches_jax():
    rng = np.random.default_rng(1)
    raw = np.zeros((40, 50), np.uint8)
    raw[10:30, 15:35] = 255
    raw[20:22, 34:38] = 100                   # soft matte
    raw[0:3, 0:4] = 200                       # touches the border
    raw += (rng.random(raw.shape) * 4).astype(np.uint8)
    for k in (3, 5):
        got = native_io.boundary_mask(raw, k)
        want = jnio.boundary_mask(raw, k)
        for g, w in zip(got, want):
            assert g.dtype == np.bool_
            np.testing.assert_array_equal(g, w)


def test_batch_items_matches_jax():
    items = [tsyn.make_items(n_joints=4, img_w=8, img_h=6, seed=s)
             for s in range(3)]
    got = tsyn.batch_items(items)
    want = jsyn.batch_items(items)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == (3,) + items[0][k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_exr_imread_imwrite_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.standard_normal((12, 10, 3)).astype(np.float32)
    texr.imwrite(str(tmp_path / "t.exr"), img)
    jexr.imwrite(str(tmp_path / "j.exr"), img)
    assert (tmp_path / "t.exr").read_bytes() == \
        (tmp_path / "j.exr").read_bytes()
    np.testing.assert_array_equal(texr.imread(str(tmp_path / "t.exr")),
                                  jexr.imread(str(tmp_path / "j.exr")))
    png = (rng.random((12, 10, 3)) * 255).astype(np.uint8)
    texr.imwrite(str(tmp_path / "t.png"), png)
    jexr.imwrite(str(tmp_path / "j.png"), png)
    np.testing.assert_array_equal(texr.imread(str(tmp_path / "t.png")),
                                  jexr.imread(str(tmp_path / "j.png")))
    # a JPEG goes through the data path's codec; the JAX helper reads it
    # with cv2, whose decoder rounds the IDCT its own way
    texr.imwrite(str(tmp_path / "t.jpg"), png)
    got = texr.imread(str(tmp_path / "t.jpg"))
    np.testing.assert_array_equal(got,
                                  image_io.read_jpeg(str(tmp_path / "t.jpg")))
    want = jexr.imread(str(tmp_path / "t.jpg"))
    assert np.mean(np.abs(got.astype(int) - want.astype(int))) < 2.0


SMALL = dict(n_frames=3, img_w=32, img_h=32, map_h=64)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    t = str(tmp_path_factory.mktemp("t_ds"))
    j = str(tmp_path_factory.mktemp("j_ds"))
    tbl.build_dataset(t, **SMALL)
    jbl.build_dataset(j, **SMALL)
    return t, j


def test_build_dataset_and_disk_dataset_match_jax(datasets):
    t, j = datasets
    names = sorted(os.listdir(j))
    assert sorted(os.listdir(t)) == names
    for n in names:
        if n != "meta.npz":              # np.savez stamps zip times
            assert open(os.path.join(t, n), "rb").read() == \
                open(os.path.join(j, n), "rb").read(), n
    tds = tbl.DiskDataset(t, SMALL["n_frames"])
    jds = jbl.DiskDataset(j, SMALL["n_frames"])
    assert len(tds) == len(jds) == SMALL["n_frames"]
    for i in range(len(jds)):
        got, want = tds[i], jds[i]
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("batch", [0, 2])
def test_timed_loop_tiny(datasets, batch):
    """The tool's loop at a tiny fixture: 1 warm-up + 2 timed steps on the
    loader's batches (B = 1 step, and the batched step at B = 2); the
    first batch the loader hands over equals the dataset's read."""
    from animatablegaussians_torch.tools import render_fixture as rf
    from animatablegaussians_torch.training import lpips as tlp

    root = datasets[0]
    net, _ = rf.build("cpu", map_h=SMALL["map_h"], img_w=SMALL["img_w"],
                      img_h=SMALL["img_h"], channel_max=8)
    run = tbl.make_run(net, batch, "cpu",
                       lpips=tlp.LPIPS(tlp.init_random(7), device="cpu"),
                       img_w=SMALL["img_w"], img_h=SMALL["img_h"],
                       patch_size=16)
    ds = tbl.DiskDataset(root, SMALL["n_frames"])
    loader = PrefetchLoader(ds, batch_size=max(batch, 1), num_threads=2,
                            device="cpu")
    first_idx = loader.index_batches(1)[0]
    first = next(iter(loader))
    want = [ds[int(i)] for i in first_idx]
    for k, v in first.items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.stack([w[k] for w in want]))
    res = tbl.timed_loop(run, loader, n_steps=2, warm=1)
    assert len(res["terms"]) == 3 and len(res["waits"]) == 2
    assert res["items_per_step"] == max(batch, 1)
    assert res["it_s"] > 0 and res["ms_step"] > 0
    assert res["wait_mean_s"] >= 0
    for terms in res["terms"]:
        assert all(np.isfinite(v) for v in terms.values()), terms
    with pytest.raises(ValueError):
        tbl.timed_loop(run, loader, n_steps=1, warm=0)


# ---------------------------------------------------------------------------
# on the card, at full width
# ---------------------------------------------------------------------------

# the loader-fed train path on a dataset of LOADER_FRAMES frames at
# 1500x2048 (the JAX tool's default is 24; 8 give B = 2 four batches an
# epoch), LOADER_THREADS decode threads, LOADER_WARMUP + LOADER_STEPS steps:
# 10 cross the end of an epoch once at B = 1 and twice at B = 2, and each
# crossing reshuffles, restarts the decode threads and prefetches anew
LOADER_FRAMES, LOADER_THREADS, LOADER_WARMUP, LOADER_STEPS = 8, 8, 1, 9
# JPEGs of the batch decode
DECODE_FILES = 16


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2])
def test_loader_fed_steps_on_the_card(full_width, train_kw, tmp_path, b):
    from animatablegaussians_torch.tools import render_fixture as rf
    net, _, fixture = full_width
    net.load_state_dict(fixture)
    dev = next(net.parameters()).device
    root = str(tmp_path / "ds")
    tbl.build_dataset(root, LOADER_FRAMES, rf.IMG_W, rf.IMG_H, rf.MAP_H)
    ds = tbl.DiskDataset(root, LOADER_FRAMES)
    run = tbl.make_run(net, 0 if b == 1 else b, dev,
                       lpips=train_kw["lpips"], img_w=rf.IMG_W,
                       img_h=rf.IMG_H)
    loader = PrefetchLoader(ds, batch_size=b, shuffle=True,
                            num_threads=LOADER_THREADS, prefetch=2,
                            device=dev)
    first_idx = loader.index_batches(1)[0]
    kept = []

    def run_keep(batch):
        if not kept:                # the first batch, as it arrived
            kept.append({k: v.clone() for k, v in batch.items()})
        return run(batch)

    reset_launches(*kernels())
    res = tbl.timed_loop(run_keep, loader, LOADER_STEPS, warm=LOADER_WARMUP)
    n = LOADER_WARMUP + LOADER_STEPS
    assert n > len(loader) and loader._epoch == -(-n // len(loader))
    assert launches(*kernels()) == dict(
        expand_pairs=b * n, blend_tiles=b * n, blend_backward=b * n,
        upfirdn2d_fir=n * sum(fir_count(net)))
    reads = [ds[int(i)] for i in first_idx]
    for k, v in kept[0].items():
        assert v.device == dev
        assert torch.equal(v.cpu(), torch.from_numpy(np.stack(
            [r[k] for r in reads]))), k
    assert all(np.isfinite(list(t.values())).all() for t in res["terms"])


@pytest.mark.gpu
def test_batch_decode_at_full_size(card, tmp_path):
    """``decode_jpeg_batch`` at 1 and LOADER_THREADS threads against
    ``decode_jpeg`` one file at a time, on colour JPEGs of 1500x2048 at
    quality 90 with bench_loader's photographic noise (a cubic upsampling
    of N(0, 1) at 1/8 size)."""
    from animatablegaussians_torch.tools import render_fixture as rf
    w, h = rf.IMG_W, rf.IMG_H
    rng = np.random.default_rng(22)
    paths = []
    for i in range(DECODE_FILES):
        tex = cv.resize(rng.standard_normal((h // 8, w // 8, 3)), (w, h),
                        interpolation=cv.INTER_CUBIC)
        paths.append(str(tmp_path / f"decode_{i:02d}.jpg"))
        cv.imwrite(paths[-1], (np.clip(0.5 + 0.25 * tex, 0, 1) * 255).astype(
            np.uint8), [cv.IMWRITE_JPEG_QUALITY, 90])
    one = np.stack([native_io.decode_jpeg(p) for p in paths])
    assert one.shape == (DECODE_FILES, h, w, 3)
    for n in (1, LOADER_THREADS):
        assert np.array_equal(native_io.decode_jpeg_batch(paths, n_threads=n),
                              one), n
