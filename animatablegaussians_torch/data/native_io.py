"""Numpy-facing JPEG decode and mask morphology of the data loader.

Port of ``animatablegaussians_tpu/data/native_io.py``: ``jpeg_info``,
``decode_jpeg``, ``decode_jpeg_batch`` and ``boundary_mask``, all through
``image_io``'s one codec (``image_io.CODEC``), chosen at import:

  * ``libjpeg``: the port's C++ core (``native/dataloader.cpp``). The batch
    decode runs in its ``std::thread`` pool (``agt_decode_jpeg_batch``),
    without the GIL.
  * ``cv2``: ``cv2.imread``. The batch runs ``n_threads`` Python threads
    over it; cv2 releases the GIL while it decodes, so this is the
    counterpart of the C++ pool.

A run never switches codec: where none exists every call raises, as
``image_io`` does. Images are BGR (H, W, 3) or grayscale (H, W) uint8, as
cv2 loads them. A batch takes files of one size and raises ``ValueError``
otherwise (the JAX version sizes the output from the first file and reads
past it for a larger one).
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from animatablegaussians_torch.data import image_io


def _cv2_read(path: str, grayscale: bool) -> np.ndarray:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if grayscale
                     else cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img


def jpeg_info(path: str) -> Tuple[int, int, int]:
    """A JPEG's (width, height, channels). With cv2 the file is decoded."""
    if image_io._need_codec() == "cv2":
        img = image_io.read_jpeg(path)
        c = 1 if img.ndim == 2 else img.shape[2]
        return img.shape[1], img.shape[0], c
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if image_io._native().agt_jpeg_info(path.encode(), ctypes.byref(w),
                                         ctypes.byref(h),
                                         ctypes.byref(c)) != 0:
        raise FileNotFoundError(path)
    return w.value, h.value, c.value


def _out_shape(n, h: int, w: int, grayscale: bool) -> tuple:
    lead = () if n is None else (n,)
    return lead + ((h, w) if grayscale else (h, w, 3))


def decode_jpeg(path: str, grayscale: bool = False) -> np.ndarray:
    """One JPEG -> (H, W, 3) BGR or, with ``grayscale``, (H, W) uint8."""
    if image_io._need_codec() == "cv2":
        return _cv2_read(path, grayscale)
    w, h, _ = jpeg_info(path)
    out = np.empty(_out_shape(None, h, w, grayscale), np.uint8)
    if image_io._native().agt_decode_jpeg(path.encode(), out.ctypes.data,
                                          1 if grayscale else 3) != 0:
        raise IOError(f"jpeg decode failed: {path}")
    return out


def decode_jpeg_batch(paths: List[str], grayscale: bool = False,
                      n_threads: int = 8) -> np.ndarray:
    """N JPEGs of one size -> (N, H, W, 3) BGR or (N, H, W) uint8, decoded
    on ``n_threads`` threads. Raises ``ValueError`` for an empty list or
    files of different sizes."""
    if not paths:
        raise ValueError("decode_jpeg_batch: no files")
    if image_io._need_codec() == "cv2":
        with ThreadPoolExecutor(max(1, min(n_threads, len(paths)))) as pool:
            imgs = list(pool.map(lambda p: _cv2_read(p, grayscale), paths))
        shapes = {im.shape for im in imgs}
        if len(shapes) != 1:
            raise ValueError(f"decode_jpeg_batch: files of sizes "
                             f"{sorted(shapes)}")
        return np.stack(imgs)
    sizes = [jpeg_info(p)[:2] for p in paths]
    if len(set(sizes)) != 1:
        raise ValueError(f"decode_jpeg_batch: files of sizes (w, h) "
                         f"{sorted(set(sizes))}")
    w, h = sizes[0]
    out = np.empty(_out_shape(len(paths), h, w, grayscale), np.uint8)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    fails = image_io._native().agt_decode_jpeg_batch(
        arr, len(paths), out.ctypes.data, out.strides[0],
        1 if grayscale else 3, n_threads)
    if fails:
        raise IOError(f"{fails} jpeg decodes failed")
    return out


def boundary_mask(raw: np.ndarray, kernel_size: int = 5):
    """(H, W) matte -> (boundary band, binarized mask), both bool
    (``image_io.boundary_mask``; ref: dataset_mv_rgb.py:263-285)."""
    return image_io.boundary_mask(
        np.ascontiguousarray(np.asarray(raw).astype(np.uint8)), kernel_size)
