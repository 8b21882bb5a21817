"""Image I/O of the data path: the port's counterpart of the JAX package's
``mv_rgb_dataset._imread``; ``data/native_io.py`` puts the JAX package's
numpy-facing decode API (with the threaded batch decode) over the same
codec.

EXR files (the pose maps) go through the bundled codec (``utils/exr.py``).
JPEG files go through ONE codec, chosen when this module is imported and
named in a log line (``CODEC``), in this order of preference:

  * ``libjpeg``: the port's copy of the JAX package's C++ core
    (``native/dataloader.cpp``), built with ``g++ ... -ljpeg`` into
    ``build/native-<hash>/`` at the first call and loaded with ctypes;
    chosen where ``jpeglib.h``, ``libjpeg`` and ``g++`` are all present;
  * ``cv2``: OpenCV's ``imread`` / ``imwrite``.

A run never switches codec: when the chosen one fails to build or to read a
file, the call raises. Where neither exists, ``CODEC`` is None and every
JPEG call raises. PNG files (ActorsHQ's masks) need ``cv2``. Writes use the
same codec as reads (quality 95, cv2's default). Images stay BGR, as cv2
loads them, and a one-channel JPEG stays (H, W) (``cv2.IMREAD_UNCHANGED``).

The mask's boundary band (``boundary_mask``) is a 5x5 erode and dilate as
two ``max_pool2d`` calls, with cv2's border rule: pixels outside the image
never erode or dilate anything.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from animatablegaussians_torch.utils import exr

log = logging.getLogger(__name__)

NATIVE_SRC = Path(__file__).resolve().parents[1] / "native" / "dataloader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
JPEG_QUALITY = 95
_INCLUDE_DIRS = ("/usr/include", "/usr/local/include",
                 "/usr/include/x86_64-linux-gnu")


def _has_libjpeg() -> bool:
    return (shutil.which("g++") is not None
            and ctypes.util.find_library("jpeg") is not None
            and any(os.path.exists(os.path.join(d, "jpeglib.h"))
                    for d in _INCLUDE_DIRS))


def _has_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def _choose_codec():
    if _has_libjpeg():
        return "libjpeg"
    if _has_cv2():
        return "cv2"
    return None


CODEC = _choose_codec()
log.info("JPEG codec: %s", CODEC or "none (no libjpeg toolchain, no cv2)")

_lib = None
_lib_lock = threading.Lock()


def _native():
    """The libjpeg core's ctypes library, built first if needed."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        h.update(NATIVE_SRC.read_bytes())
        out_dir = BUILD_ROOT / f"native-{h.hexdigest()[:16]}"
        so = out_dir / "libagtjpeg.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"libagtjpeg.{os.getpid()}.so"
            res = subprocess.run(["g++", *GXX_FLAGS, str(NATIVE_SRC), "-o",
                                  str(tmp), "-ljpeg"], capture_output=True,
                                 text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed on {NATIVE_SRC.name}:\n"
                                   f"{res.stdout}{res.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _I, _P = ctypes.c_int, ctypes.c_void_p
        lib.agt_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(_I),
                                      ctypes.POINTER(_I), ctypes.POINTER(_I)]
        lib.agt_decode_jpeg.argtypes = [ctypes.c_char_p, _P, _I]
        lib.agt_encode_jpeg.argtypes = [ctypes.c_char_p, _P, _I, _I, _I, _I]
        lib.agt_decode_jpeg_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), _I, _P, ctypes.c_int64, _I, _I]
        for fn in (lib.agt_jpeg_info, lib.agt_decode_jpeg,
                   lib.agt_encode_jpeg, lib.agt_decode_jpeg_batch):
            fn.restype = _I
        _lib = lib
        return lib


def _need_codec() -> str:
    if CODEC is None:
        raise RuntimeError("no JPEG codec: needs libjpeg (jpeglib.h, "
                           "libjpeg.so and g++) or cv2")
    return CODEC


def read_jpeg(path: str) -> np.ndarray:
    """JPEG -> (H, W, 3) BGR or, for a one-channel file, (H, W) uint8."""
    if _need_codec() == "cv2":
        import cv2
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img
    lib = _native()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.agt_jpeg_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(c)) != 0:
        raise FileNotFoundError(path)
    ch = 1 if c.value == 1 else 3
    out = np.empty((h.value, w.value, 3) if ch == 3 else (h.value, w.value),
                   np.uint8)
    if lib.agt_decode_jpeg(path.encode(), out.ctypes.data, ch) != 0:
        raise IOError(f"jpeg decode failed: {path}")
    return out


def write_jpeg(path: str, img: np.ndarray) -> None:
    """(H, W, 3) BGR or (H, W) uint8 -> a JPEG at ``JPEG_QUALITY``."""
    img = np.ascontiguousarray(img, np.uint8)
    if _need_codec() == "cv2":
        import cv2
        if not cv2.imwrite(path, img,
                           [cv2.IMWRITE_JPEG_QUALITY, JPEG_QUALITY]):
            raise IOError(f"jpeg encode failed: {path}")
        return
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ch not in (1, 3):
        raise ValueError(f"write_jpeg takes 1 or 3 channels, not {ch}")
    if _native().agt_encode_jpeg(path.encode(), img.ctypes.data,
                                 img.shape[0], img.shape[1], ch,
                                 JPEG_QUALITY) != 0:
        raise IOError(f"jpeg encode failed: {path}")


def imread(path: str) -> np.ndarray:
    """An image file as the dataset reads it: ``.exr`` float through the
    bundled codec, ``.jpg`` through ``CODEC``, ``.png`` through cv2."""
    if path.endswith(".exr"):
        return exr.read_exr(path)
    if path.endswith((".jpg", ".jpeg")):
        return read_jpeg(path)
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    return img


def boundary_mask(mask: np.ndarray, kernel_size: int = 5):
    """(H, W) uint8 matte -> (boundary band, binarized mask), both bool:
    binarize at > 128; the band is dilate - erode of the binary mask with a
    ``kernel_size`` square, plus the soft-matte pixels in (5, 250) (ref:
    dataset_mv_rgb.py:263-285)."""
    binary = torch.from_numpy(np.asarray(mask) > 128)
    x = binary.to(torch.float32)[None, None]
    pad = kernel_size // 2
    # max_pool2d pads with -inf: outside pixels take part in neither max
    dilate = F.max_pool2d(x, kernel_size, stride=1, padding=pad)
    erode = -F.max_pool2d(-x, kernel_size, stride=1, padding=pad)
    band = (dilate - erode)[0, 0] == 1
    soft = (mask > 5) & (mask < 250)
    return np.logical_or(band.numpy(), soft), binary.numpy()
