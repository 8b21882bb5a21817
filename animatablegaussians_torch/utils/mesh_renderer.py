"""Software mesh rasterizer, a numpy copy of
``animatablegaussians_tpu/utils/mesh_renderer.py``: orthographic /
perspective, vertex-attribute interpolated, z-buffered.

It replaces the reference's monitor-dependent OpenGL / PyTorch3D renderers
(ref: utils/renderer/__init__.py:12-17, renderer_pytorch3d.py:29-120) for
the skeleton overlay of the animation path. Camera conventions match the
reference's OpenCV-style screen mapping:

  * perspective (intr given): u = fx x/z + cx, v = fy y/z + cy;
  * orthographic (no intr):  u = (W/2) x + W/2, v = (H/2) y + H/2
    (focal = principal = half image size, in_ndc=False;
    ref: renderer_pytorch3d.py:79-88);
  * nearest-z wins; flat vertex attributes interpolated barycentrically.

Chunked painter's algorithm: candidates are sorted back-to-front and
written with flat-index assignment, so the final write per pixel is the
nearest face. Host-side, not a hot path.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _rasterize(verts_screen: np.ndarray, faces: np.ndarray,
               attrs: np.ndarray, img_w: int, img_h: int,
               bg_value: float = 0.0, chunk: int = 2048):
    """verts_screen (V, 3) = (u, v, z_view); attrs (V, C) -> (H, W, C)."""
    C = attrs.shape[1]
    img = np.full((img_h * img_w, C), bg_value, np.float32)
    zbuf = np.full((img_h * img_w,), np.inf, np.float32)

    tri = verts_screen[faces]                          # (F, 3, 3)
    ta = attrs[faces]                                  # (F, 3, C)

    for s in range(0, faces.shape[0], chunk):
        t = tri[s:s + chunk]                           # (f, 3, 3)
        a = ta[s:s + chunk]
        u0 = np.floor(t[..., 0].min(1)).astype(int)
        u1 = np.ceil(t[..., 0].max(1)).astype(int)
        v0 = np.floor(t[..., 1].min(1)).astype(int)
        v1 = np.ceil(t[..., 1].max(1)).astype(int)
        u0c = np.clip(u0, 0, img_w - 1)
        v0c = np.clip(v0, 0, img_h - 1)
        bw = np.clip(u1, 0, img_w - 1) - u0c + 1
        bh = np.clip(v1, 0, img_h - 1) - v0c + 1
        K = int(max(bw.max(initial=1), bh.max(initial=1)))
        K = min(K, 256)

        du = np.arange(K)
        uu = u0c[:, None, None] + du[None, None, :]    # (f, 1, K)
        vv = v0c[:, None, None] + du[None, :, None]    # (f, K, 1)
        uu = np.broadcast_to(uu, (t.shape[0], K, K)).astype(np.float32)
        vv = np.broadcast_to(vv, (t.shape[0], K, K)).astype(np.float32)
        inside_img = ((uu < img_w) & (vv < img_h)
                      & (uu - u0c[:, None, None] < bw[:, None, None])
                      & (vv - v0c[:, None, None] < bh[:, None, None]))

        # barycentric at pixel centers
        x0, y0 = t[:, 0, 0, None, None], t[:, 0, 1, None, None]
        x1, y1 = t[:, 1, 0, None, None], t[:, 1, 1, None, None]
        x2, y2 = t[:, 2, 0, None, None], t[:, 2, 1, None, None]
        den = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        den = np.where(np.abs(den) < 1e-12, 1e-12, den)
        w0 = ((y1 - y2) * (uu - x2) + (x2 - x1) * (vv - y2)) / den
        w1 = ((y2 - y0) * (uu - x2) + (x0 - x2) * (vv - y2)) / den
        w2 = 1.0 - w0 - w1
        eps = -1e-5
        hit = inside_img & (w0 >= eps) & (w1 >= eps) & (w2 >= eps)

        if not hit.any():
            continue
        z = (w0 * t[:, 0, 2, None, None] + w1 * t[:, 1, 2, None, None]
             + w2 * t[:, 2, 2, None, None])
        fi, yi, xi = np.nonzero(hit)
        flat = (v0c[fi] + yi) * img_w + (u0c[fi] + xi)
        zs = z[fi, yi, xi]

        # keep only candidates beating the current z-buffer, then sort
        # back-to-front so the last write per pixel is the nearest
        better = zs < zbuf[flat]
        fi, yi, xi, flat, zs = (fi[better], yi[better], xi[better],
                                flat[better], zs[better])
        order = np.argsort(-zs, kind="stable")
        fi, yi, xi, flat, zs = (fi[order], yi[order], xi[order],
                                flat[order], zs[order])
        vals = (w0[fi, yi, xi, None] * a[fi, 0]
                + w1[fi, yi, xi, None] * a[fi, 1]
                + w2[fi, yi, xi, None] * a[fi, 2])
        img[flat] = vals
        np.minimum.at(zbuf, flat, zs)

    return img.reshape(img_h, img_w, C)


class Renderer:
    """API mirror of the reference Renderer (set_camera / set_model /
    render) for drop-in use by the preprocessing tools."""

    def __init__(self, img_w: int, img_h: int,
                 shader_name: str = "vertex_attribute",
                 bg_color=(0, 0, 0), **_):
        self.img_w = img_w
        self.img_h = img_h
        self.shader_name = shader_name
        self.bg_color = np.asarray(bg_color, np.float32)
        self.extr: Optional[np.ndarray] = None
        self.intr: Optional[np.ndarray] = None
        self.verts = self.attrs = None

    def set_camera(self, extr: np.ndarray, intr: Optional[np.ndarray] = None):
        self.extr = np.asarray(extr, np.float32)
        self.intr = None if intr is None else np.asarray(intr, np.float32)

    def set_model(self, vertices: np.ndarray,
                  vertex_attributes: Optional[np.ndarray] = None):
        """vertices are face-duplicated (3*F, 3), faces implicit
        (ref: renderer_pytorch3d.py:109)."""
        self.verts = np.asarray(vertices, np.float32)
        if vertex_attributes is None:
            vertex_attributes = np.ones_like(self.verts)
        self.attrs = np.asarray(vertex_attributes, np.float32)

    def render(self) -> np.ndarray:
        v = self.verts @ self.extr[:3, :3].T + self.extr[:3, 3]
        if self.intr is None:  # orthographic
            u = 0.5 * self.img_w * v[:, 0] + 0.5 * self.img_w
            w = 0.5 * self.img_h * v[:, 1] + 0.5 * self.img_h
        else:
            z = np.maximum(v[:, 2], 1e-6)
            u = self.intr[0, 0] * v[:, 0] / z + self.intr[0, 2]
            w = self.intr[1, 1] * v[:, 1] / z + self.intr[1, 2]
        screen = np.stack([u, w, v[:, 2]], -1).astype(np.float32)
        faces = np.arange(self.verts.shape[0], dtype=np.int64).reshape(-1, 3)

        attrs = self.attrs
        if self.shader_name == "phong_geometry":
            # simple headlight diffuse on the provided normals
            n = attrs / np.maximum(
                np.linalg.norm(attrs, axis=-1, keepdims=True), 1e-8)
            lam = np.clip(-(n @ self.extr[:3, :3].T)[:, 2], 0.05, 1.0)
            attrs = np.repeat(lam[:, None], 3, axis=1)

        out = _rasterize(screen, faces, attrs, self.img_w, self.img_h)
        bg_mask = (out == 0).all(-1)
        if self.bg_color.any():
            out[bg_mask] = self.bg_color
        return out
