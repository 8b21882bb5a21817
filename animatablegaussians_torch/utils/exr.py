"""Self-contained OpenEXR scanline codec (read + write): a copy of
``animatablegaussians_tpu/utils/exr.py``, so the port never imports the JAX
package; ``imread`` / ``imwrite`` send other formats to the data path's
codec.

The reference stores pose maps as cv2-written EXRs
(ref: gen_data/gen_pos_maps.py:110-162, dataset_mv_rgb.py:146-151), but
OpenCV builds may lack EXR support and no other library on hand reads it.
This module implements the needed subset of OpenEXR 2.0 directly:

  * single-part scanline files;
  * NO_COMPRESSION, ZIPS (1 line/block) and ZIP (16 lines/block) — the
    OpenEXR zlib scheme (deinterleave + byte delta + deflate);
  * HALF and FLOAT channels; arbitrary channel sets (B/G/R[/A] ordered the
    cv2 way, i.e. array channel 0 = "B", matching files the reference wrote
    and files cv2 would read).

Vectorized numpy throughout (the delta predictor is a cumsum mod 256).
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

MAGIC = 0x01312f76
PT_UINT, PT_HALF, PT_FLOAT = 0, 1, 2
NO_COMPRESSION, RLE, ZIPS, ZIP = 0, 1, 2, 3
_DTYPE = {PT_HALF: np.float16, PT_FLOAT: np.float32, PT_UINT: np.uint32}
_SIZE = {PT_HALF: 2, PT_FLOAT: 4, PT_UINT: 4}


def _zip_decompress(data: bytes, out_size: int) -> np.ndarray:
    raw = np.frombuffer(zlib.decompress(data), np.uint8)
    if raw.size != out_size:
        raise ValueError("exr: bad zip block size")
    # inverse predictor: t[i] = t[i-1] + t[i] - 128 (mod 256)
    idx = np.arange(raw.size, dtype=np.int64)
    rec = (np.cumsum(raw.astype(np.int64)) - 128 * idx) % 256
    rec = rec.astype(np.uint8)
    # interleave the two halves
    out = np.empty(raw.size, np.uint8)
    half = (raw.size + 1) // 2
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out


def _zip_compress(buf: np.ndarray) -> bytes:
    # deinterleave
    half = (buf.size + 1) // 2
    re = np.empty(buf.size, np.uint8)
    re[:half] = buf[0::2]
    re[half:] = buf[1::2]
    # forward predictor: d[i] = t[i] - t[i-1] + 128 (mod 256)
    d = re.astype(np.int64)
    d[1:] = (d[1:] - d[:-1] + 128) % 256
    return zlib.compress(d.astype(np.uint8).tobytes(),
                         zlib.Z_DEFAULT_COMPRESSION)


def _read_cstr(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin1"), end + 1


def _parse_header(buf: bytes, off: int):
    attrs = {}
    while True:
        name, off = _read_cstr(buf, off)
        if name == "":
            break
        typ, off = _read_cstr(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        attrs[name] = (typ, buf[off:off + size])
        off += size
    return attrs, off


def _parse_chlist(data: bytes) -> List[Tuple[str, int]]:
    chans = []
    off = 0
    while data[off] != 0:
        name, off = _read_cstr(data, off)
        ptype = struct.unpack_from("<i", data, off)[0]
        off += 16  # ptype + pLinear/pad + xSampling + ySampling
        chans.append((name, ptype))
    return chans


def _order_channels(names: List[str]) -> List[str]:
    """Array channel order: cv2 convention (B, G, R, A) when applicable,
    else file (alphabetical) order."""
    ns = set(names)
    if ns == {"B", "G", "R"}:
        return ["B", "G", "R"]
    if ns == {"A", "B", "G", "R"}:
        return ["B", "G", "R", "A"]
    return list(names)


def read_exr(path: str) -> np.ndarray:
    """Returns (H, W) or (H, W, C) float32 (uint stays uint32)."""
    with open(path, "rb") as fp:
        buf = fp.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    attrs, off = _parse_header(buf, 8)

    chans = _parse_chlist(attrs["channels"][1])        # file order (sorted)
    comp = attrs["compression"][1][0]
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    W, H = xmax - xmin + 1, ymax - ymin + 1

    if comp == NO_COMPRESSION or comp == ZIPS:
        lines_per_block = 1
    elif comp == ZIP:
        lines_per_block = 16
    else:
        raise ValueError(f"unsupported EXR compression {comp}")

    n_blocks = -(-H // lines_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, off)

    bytes_per_px = sum(_SIZE[pt] for _, pt in chans)
    planes = {name: np.empty((H, W), _DTYPE[pt]) for name, pt in chans}

    for bi, boff in enumerate(offsets):
        y, size = struct.unpack_from("<ii", buf, boff)
        data = buf[boff + 8: boff + 8 + size]
        y0 = y - ymin
        n_lines = min(lines_per_block, H - y0)
        out_size = n_lines * W * bytes_per_px
        # blocks whose packed size >= unpacked size are stored raw
        # (OpenEXR convention, also used by our writer's fallback)
        if comp == NO_COMPRESSION or size >= out_size:
            raw = np.frombuffer(data[:out_size], np.uint8)
        else:
            raw = _zip_decompress(data, out_size)
        pos = 0
        for li in range(n_lines):
            for name, pt in chans:
                nb = W * _SIZE[pt]
                planes[name][y0 + li] = np.frombuffer(
                    raw[pos:pos + nb].tobytes(), _DTYPE[pt])
                pos += nb

    order = _order_channels([n for n, _ in chans])
    stack = [planes[n].astype(np.float32)
             if planes[n].dtype == np.float16 else planes[n]
             for n in order]
    if len(stack) == 1:
        return stack[0].astype(np.float32)
    return np.stack(stack, axis=-1).astype(np.float32)


def write_exr(path: str, img: np.ndarray, half: bool = False,
              compression: int = ZIP) -> None:
    """img (H, W) or (H, W, C<=4) float; channels stored cv2-style
    (array ch0 -> 'B')."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    names = {1: ["Y"], 3: ["B", "G", "R"],
             4: ["B", "G", "R", "A"]}.get(C)
    if names is None:
        names = [f"C{i}" for i in range(C)]
    ptype = PT_HALF if half else PT_FLOAT
    dtype = _DTYPE[ptype]
    planes = {n: np.ascontiguousarray(img[..., i].astype(dtype))
              for i, n in enumerate(names)}
    file_order = sorted(names)

    # header
    def attr(name, typ, data):
        return (name.encode() + b"\x00" + typ.encode() + b"\x00"
                + struct.pack("<i", len(data)) + data)

    chl = b""
    for n in file_order:
        chl += (n.encode() + b"\x00" + struct.pack("<i", ptype)
                + b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1))
    chl += b"\x00"
    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = b"".join([
        attr("channels", "chlist", chl),
        attr("compression", "compression", bytes([compression])),
        attr("dataWindow", "box2i", box),
        attr("displayWindow", "box2i", box),
        attr("lineOrder", "lineOrder", b"\x00"),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\x00",
    ])

    lines_per_block = {NO_COMPRESSION: 1, ZIPS: 1, ZIP: 16}[compression]
    n_blocks = -(-H // lines_per_block)

    blocks = []
    for bi in range(n_blocks):
        y0 = bi * lines_per_block
        n_lines = min(lines_per_block, H - y0)
        parts = []
        for li in range(n_lines):
            for n in file_order:
                parts.append(planes[n][y0 + li].tobytes())
        raw = np.frombuffer(b"".join(parts), np.uint8)
        if compression == NO_COMPRESSION:
            payload = raw.tobytes()
        else:
            payload = _zip_compress(raw)
            if len(payload) >= raw.size:   # OpenEXR stores raw if bigger
                payload = raw.tobytes()
        blocks.append((y0, payload))

    base = 8 + len(header) + 8 * n_blocks
    offsets = []
    pos = base
    for y0, payload in blocks:
        offsets.append(pos)
        pos += 8 + len(payload)

    with open(path, "wb") as fp:
        fp.write(struct.pack("<ii", MAGIC, 2))
        fp.write(header)
        fp.write(struct.pack(f"<{n_blocks}q", *offsets))
        for y0, payload in blocks:
            fp.write(struct.pack("<ii", y0, len(payload)))
            fp.write(payload)


def imread(path: str):
    """An image file: ``.exr`` through this codec, the rest through the
    data path's reader (``data/image_io.imread``: JPEG through its one
    codec, other formats through cv2)."""
    if path.endswith(".exr"):
        return read_exr(path)
    from animatablegaussians_torch.data import image_io
    return image_io.imread(path)


def imwrite(path: str, img: np.ndarray):
    """``img`` to ``path``: ``.exr`` through this codec, JPEG through the
    data path's codec (``image_io.write_jpeg``), other formats through
    cv2. Raises ``IOError`` where cv2 refuses."""
    if path.endswith(".exr"):
        return write_exr(path, img)
    from animatablegaussians_torch.data import image_io
    if path.endswith((".jpg", ".jpeg")):
        return image_io.write_jpeg(path, img)
    import cv2
    if not cv2.imwrite(path, img):
        raise IOError(f"cv2 could not write {path}")
