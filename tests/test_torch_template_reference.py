"""The template cell's plain reference (``portbench/reference/template.py``)
against the port, on the CPU at a small size: its nearest-face search
against ``ops/geometry3d.nearest_face`` (with planted ties), and the cell
``zzr-template-train`` run end to end (the port's ``TemplateStep`` held
to the reference on the first step's loss terms, the gradients by group
and the change after three Adam steps, with hands and root finding on):
a sound run is correct, and each planted fault fails the cell's own
check. The reference imports neither the port nor JAX."""

import ast
import os

import pytest
import torch

from animatablegaussians_torch.ops import geometry3d as g3d
from portbench import run as R
from portbench.drivers import template as drv
from portbench.reference import template as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "zzr-template-train"
# about 64 rays x 16 samples, a body of 400 faces, hands of 76, a 16^3
# volume, 96x128 images
TINY = {"body": {"n_verts": 230, "n_faces": 400, "mano_verts": 40,
                 "mano_faces": 76, "volume_res": 16},
        "camera": {"img_w": 96, "img_h": 128, "train_focal": 115.2},
        "train": {"rays": 64, "n_samples": 16}}
SEED = 2_147_483_901


@pytest.fixture
def threads():
    """``run`` sets torch's threads for a card's host; the suite's own
    count comes back after the test."""
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def test_reference_imports_neither_the_port_nor_jax():
    path = os.path.join(ROOT, "portbench", "reference", "template.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "math", "torch"}


def _mesh(n_faces: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    verts = torch.randn((n_faces // 2 + 2, 3), generator=g)
    faces = torch.randint(0, verts.shape[0], (n_faces, 3), generator=g)
    faces = faces[(faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
                  & (faces[:, 0] != faces[:, 2])]
    return verts, faces


def test_nearest_face_against_the_port_with_planted_ties():
    verts, faces = _mesh(300, 0)
    # each face twice, the copy later: the first index must win
    faces = torch.cat([faces, faces.flip(0)])
    g = torch.Generator().manual_seed(1)
    pts = torch.cat([1.5 * torch.randn((400, 3), generator=g),
                     verts[:20] + 1e-3 * torch.randn((20, 3), generator=g)])
    d0, i0, b0 = g3d.nearest_face(pts, verts, faces)
    d1, i1, b1 = ref.nearest_face(pts, verts, faces)
    assert torch.allclose(d1, d0, atol=1e-6, rtol=1e-5)
    n = faces.shape[0] // 2
    assert bool((i1 < n).all()) and bool((i0 < n).all())
    # where the nearest face is one, the face and its weights agree; where
    # several faces tie (an edge or a vertex), the closest point agrees
    tri = verts[faces]
    p0 = torch.einsum("nk,nkc->nc", b0, tri[i0])
    p1 = torch.einsum("nk,nkc->nc", b1, tri[i1])
    assert torch.allclose(p1, p0, atol=1e-5)
    same = i0 == i1
    assert float(same.float().mean()) > 0.8
    assert torch.allclose(b1[same], b0[same], atol=1e-4)


def test_inv3_and_sobel():
    g = torch.Generator().manual_seed(2)
    m = 0.3 * torch.randn((64, 3, 3), generator=g) + torch.eye(3)
    assert torch.allclose(ref.inv3(m), torch.linalg.inv(m), atol=1e-5)
    from animatablegaussians_torch.models.volume import \
        compute_gradient_volume
    vol = torch.rand((6, 7, 8, 4), generator=g)
    vox = torch.tensor([0.1, 0.2, 0.3])
    ours = ref.sobel_gradient(vol.permute(3, 0, 1, 2), vox)
    port = compute_gradient_volume(vol, vox).permute(3, 4, 0, 1, 2)
    assert torch.allclose(ours, port, atol=1e-5)


def test_sound_run_is_correct(threads):
    res = R.run(CELL, SEED, 0.3, False, device="cpu", overrides=TINY,
                readings=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    for k, v in res["checks"].items():
        assert v["value"] <= v["limit"], k
    # the step held tighter than the card's limits at this size
    assert res["numbers"]["loss1_gap"] < 1e-5
    assert res["numbers"]["grad_gap"] < 1e-3
    assert set(res["leaves"]["program"]["grad"]) == set(ref.GROUPS)


@pytest.mark.parametrize("fault", drv.FAULTS)
def test_planted_fault_is_not_correct(threads, fault):
    res = R.run(CELL, SEED, 0.01, False, device="cpu", overrides=TINY,
                fault=fault)
    assert not res["correct"], res["checks"]
