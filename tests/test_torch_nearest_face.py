"""The nearest-face search (``ops/geometry3d.nearest_face``): its plain
version and its CUDA kernel (``csrc/nearest_face.cu``).

On the CPU: ``nearest_face`` runs ``nearest_face_plain``, counts no launch
and keeps its span and counters; the plain version keeps planted ties
(a shared edge, a shared vertex) on the first face, stays finite on
zero-area faces and gives the same bits at any ``chunk``; and the
kernel's search, repeated here in Python (its ranges of (point block,
face tile) pairs, one a resident block, and the 64-bit key they merge
by), picks torch.argmin's face for every cut, NaN and ties included.

Marked ``gpu`` (skipped without a CUDA device): the kernel against
``nearest_face_plain`` on the card, bit for bit, on random meshes,
planted ties, degenerate faces, flipped, strided and int32 faces, and at
the template cell's shapes (65,536 points against 20,908 and 1,552
faces), one launch a call; and a vertex index out of range stops the
kernel with a CUDA error. This file imports neither JAX nor the JAX
package. On a machine with a CUDA device: ``python -m pytest
tests/test_torch_nearest_face.py -q``."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from animatablegaussians_torch.ops import geometry3d as g3d
from animatablegaussians_torch.utils import profiling as P

# csrc/nearest_face.cu's points a block and faces a tile, read from its
# source
_CU = open(os.path.join(os.path.dirname(g3d.__file__), os.pardir, "csrc",
                        "nearest_face.cu")).read()
_DEF = {k: int(v) for k, v in re.findall(r"#define (NF_\w+) (\d+)", _CU)}
BLOCK_PTS, NF_TILE = _DEF["NF_THREADS"], _DEF["NF_TILE"]


def _mesh(n_verts: int, n_faces: int, seed: int, scale: float = 1.0):
    r = np.random.default_rng(seed)
    v = torch.as_tensor(r.standard_normal((n_verts, 3)) * scale,
                        dtype=torch.float32)
    f = torch.as_tensor(r.integers(0, n_verts, (n_faces, 3)))
    return v, f


def _points(n: int, seed: int, scale: float = 1.0):
    r = np.random.default_rng(seed)
    return torch.as_tensor(r.standard_normal((n, 3)) * scale,
                           dtype=torch.float32)


def _same_bits(a, b) -> bool:
    """Equal as bits (floats: NaNs with their payloads, signed zeros)."""
    if a.dtype.is_floating_point:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _planted():
    """Integer and half-integer corners, so that every product and sum
    below is exact: faces 0, 1 and 2 share the vertex A at the origin,
    faces 0 and 1 also the edge A-B. Point 0 lies 1 above A-B and 1 to
    its side, nearest to (1.5, 0, 0) in faces 0 and 1; point 1 lies 1
    above A, nearest to A in faces 0, 1 and 2; face 3 lies far away."""
    v = torch.tensor([[0., 0., 0.], [2., 0., 0.], [0., 2., 0.],
                      [1., 0., -2.], [-2., 0., 0.], [0., -2., 0.],
                      [9., 9., 9.], [9., 10., 9.], [10., 9., 9.]])
    f = torch.tensor([[0, 1, 2], [0, 1, 3], [0, 4, 5], [6, 7, 8]])
    p = torch.tensor([[1.5, -1., 1.], [0., 0., 1.]])
    return p, v, f


def test_cpu_runs_the_plain_version_and_counts_no_launch(monkeypatch):
    p, (v, f) = _points(300, 0), _mesh(40, 90, 1)

    def no_kernel(*a, **k):
        raise AssertionError("the kernel ran on the CPU")

    monkeypatch.setattr(g3d, "_nearest_face_kernel", no_kernel)
    P.reset_counters()
    P.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = g3d.nearest_face(p, v, f)
    want = g3d.nearest_face_plain(p, v, f)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    c = P.counters()
    assert c["nearest_face.calls"] == 1
    assert c["nearest_face.pairs"] == 300 * 90
    assert "nearest_face.launches" not in c
    rec = [r for r in P.spans() if r["name"] == "nearest_face"]
    assert len(rec) == 1
    assert rec[0]["args"] == {"points": 300, "faces": 90, "pairs": 27000}


def test_plain_keeps_planted_ties_on_the_first_face():
    p, v, f = _planted()
    d = torch.stack([g3d.nearest_face_plain(p, v, f[k:k + 1])[0]
                     for k in range(4)], 1)              # (point, face)
    assert d[0, 0] == d[0, 1] < d[0, 2] < d[0, 3]      # the shared edge
    assert d[1, 0] == d[1, 1] == d[1, 2] == 1.0 < d[1, 3]  # the vertex
    for order in ([0, 1, 2, 3], [1, 0, 2, 3], [3, 2, 1, 0], [3, 1, 0, 2],
                  [2, 3, 0, 1]):
        _, idx, bary = g3d.nearest_face_plain(p, v, f[order])
        dd = d[:, order]
        want = [int(torch.nonzero(dd[i] == dd[i].min())[0]) for i in (0, 1)]
        assert idx.tolist() == want, order
        assert torch.all(bary >= 0) and torch.allclose(bary.sum(-1),
                                                       torch.ones(2))


def test_plain_is_finite_on_zero_area_faces():
    v, f = _mesh(30, 40, 2)
    vd = torch.cat([v, (v[:4] + v[4:8]) / 2])                # midpoints
    fd = torch.cat([f, torch.tensor([[0, 0, 1], [2, 2, 2], [0, 4, 30],
                                     [1, 5, 31], [3, 3, 3]])])
    p = torch.cat([_points(500, 3), v[:3], vd[30:]])
    for faces in (fd, fd[-5:]):
        d, idx, bary = g3d.nearest_face_plain(p, vd, faces)
        assert torch.isfinite(d).all() and torch.isfinite(bary).all()
        assert ((idx >= 0) & (idx < faces.shape[0])).all()
        surf = g3d.barycentric_interpolate(vd, faces, idx, bary)
        assert torch.allclose((surf - p).norm(dim=-1), d, atol=1e-5)


def test_plain_gives_the_same_bits_at_any_chunk():
    p, (v, f) = _points(257, 4), _mesh(60, 123, 5)
    want = g3d.nearest_face_plain(p, v, f)
    for chunk in (1, 7):
        got = g3d.nearest_face_plain(p, v, f, chunk=chunk)
        assert all(_same_bits(a, b) for a, b in zip(got, want)), chunk


def _kernel_search(d2: torch.Tensor, grid: int) -> torch.Tensor:
    """csrc/nearest_face.cu's search and merge on a (points, faces) table
    of squared distances: ``grid`` blocks, each one contiguous range of the
    (point block, face tile) pairs; a lane keeps the first of its least
    keys and merges it into its point's key with a minimum."""
    n, n_faces = d2.shape
    n_tiles = -(-n_faces // NF_TILE)
    total = -(-n // BLOCK_PTS) * n_tiles
    bits = d2.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rank = torch.where(torch.isnan(d2), 0, bits + 1)
    keys = torch.full((n,), 2 ** 63 - 1, dtype=torch.int64)  # "~0"
    covered = torch.zeros((n, n_faces), dtype=torch.int64)
    for b in range(grid):
        it, hi = total * b // grid, total * (b + 1) // grid
        while it < hi:
            pb = it // n_tiles
            t1 = min(hi, (pb + 1) * n_tiles) - pb * n_tiles
            rows = slice(pb * BLOCK_PTS, min(n, (pb + 1) * BLOCK_PTS))
            cols = slice((it - pb * n_tiles) * NF_TILE,
                         min(n_faces, t1 * NF_TILE))
            covered[rows, cols] += 1
            r = rank[rows, cols]
            j = torch.argmin(r, dim=1)                   # first of the least
            key = (torch.gather(r, 1, j[:, None])[:, 0] << 32) | (
                j + cols.start)
            keys[rows] = torch.minimum(keys[rows], key)
            it = pb * n_tiles + t1
    assert torch.all(covered == 1)
    return keys & 0xFFFFFFFF


@pytest.mark.parametrize("n,n_faces", [(700, 20908 // 20), (1000, 1552),
                                       (300, 3), (513, 257)])
def test_kernel_ranges_pick_argmin_first_index(n, n_faces):
    g = torch.Generator().manual_seed(n + n_faces)
    d2 = torch.randint(0, 40, (n, n_faces), generator=g).float() / 8
    d2[5, 3 % n_faces] = float("nan")                # NaN wins, first one
    d2[7, :] = float("nan")
    d2[9, :] = 1.0                                   # all tied
    d2[11, -1] = 0.0
    want = torch.argmin(d2, dim=1)
    for grid in (1, 3, 132 * 6, 10 ** 6):
        n_tiles = -(-n_faces // NF_TILE)
        grid = min(grid, -(-n // BLOCK_PTS) * n_tiles)
        assert torch.equal(_kernel_search(d2, grid), want), grid


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _check_on_card(dev, p, v, f):
    p, v, f = p.to(dev), v.to(dev), f.to(dev)
    P.reset_counters()
    got = g3d.nearest_face(p, v, f)
    want = g3d.nearest_face_plain(p, v, f)
    c = P.counters()
    assert c["nearest_face.launches"] == c["nearest_face.calls"] == 1
    for a, b, name in zip(got, want, ("distance", "index", "weights")):
        assert _same_bits(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_plain_on_random_meshes(card, seed):
    v, f = _mesh(500, 1000, seed)
    _check_on_card(card, _points(3000, seed + 10, 1.5), v, f)


@pytest.mark.gpu
def test_kernel_matches_plain_on_planted_ties(card):
    p, v, f = _planted()
    for order in ([0, 1, 2, 3], [1, 0, 2, 3], [3, 2, 1, 0], [2, 3, 0, 1]):
        _check_on_card(card, p, v, f[order])
    v, f = _mesh(60, 200, 3)                  # every face twice, rotated
    f = torch.cat([f, f.flip(0), f[:, [1, 2, 0]]])
    _check_on_card(card, torch.cat([_points(5000, 4), v]), v, f)


@pytest.mark.gpu
def test_kernel_matches_plain_on_degenerate_faces(card):
    v, f = _mesh(60, 200, 5)
    vd = torch.cat([v, (v[:5] + v[5:10]) / 2])
    fd = torch.cat([f, torch.tensor([[0, 0, 1], [2, 2, 2], [0, 5, 60],
                                     [1, 6, 61]])])
    _check_on_card(card, torch.cat([_points(5000, 6), vd]), vd, fd)
    _check_on_card(card, _points(1000, 7), vd, fd[-4:])


@pytest.mark.gpu
def test_kernel_matches_plain_on_flipped_and_strided_faces(card):
    v, f = _mesh(300, 700, 8)
    p = _points(4000, 9)
    fc = f.to(card)
    for faces in (torch.flip(fc, [1]), fc.t().contiguous().t(), fc[::2],
                  fc.int()):
        _check_on_card(card, p, v, faces)


@pytest.mark.gpu
@pytest.mark.parametrize("n_verts,n_faces,scale", [(10475, 20908, 0.4),
                                                   (778, 1552, 0.05)])
def test_kernel_matches_plain_at_the_template_cells_shapes(
        card, n_verts, n_faces, scale):
    v, f = _mesh(n_verts, n_faces, n_faces, scale)
    _check_on_card(card, _points(65536, 11, 0.5), v, f)


@pytest.mark.gpu
@pytest.mark.parametrize("bad", [9, -1])
def test_kernel_stops_on_a_vertex_index_out_of_range(card, bad):
    """In a process of its own: the error leaves the CUDA context
    unusable, as the plain version's failed gather does."""
    code = ("import torch\n"
            "from animatablegaussians_torch.ops import geometry3d as g3d\n"
            "v = torch.zeros((9, 3), device='cuda')\n"
            f"f = torch.tensor([[0, 1, 2], [3, {bad}, 4]], device='cuda')\n"
            "g3d.nearest_face(torch.ones((5, 3), device='cuda'), v, f)\n"
            "torch.cuda.synchronize()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA error" in res.stderr or "cudaError" in res.stderr, \
        res.stderr[-2000:]
