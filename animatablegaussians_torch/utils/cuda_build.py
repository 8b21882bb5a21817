"""Build and load the hand-written Hopper kernels.

Every ``*.cu`` file under ``animatablegaussians_torch/csrc/`` is compiled by
its own ``nvcc`` for ``sm_90a`` (all started together), and the objects are
linked into one shared library with a plain C interface, which is loaded
with ``ctypes``. The build happens at first use, into
``build/kernels-<hash>/`` at the repository root (git-ignored), keyed on a
hash of the sources, the flags and ``nvcc --version``, so a fresh checkout builds everything itself
and an unchanged one reuses its library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              # no multiply-add contraction: the kernels then round exactly
              # like the element-wise PyTorch ops of their plain versions
              "-fmad=false")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> argtypes (every one returns cudaGetLastError()).
SIGNATURES = {
    "ag_expand_pairs": [_P, _P, _P, _I, _I, _P, _P, _P],
    "ag_blend_forward": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "ag_blend_backward": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P, _P, _P],
    "ag_upfirdn2d_fir": [_P, _P, _P, _P],
}

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def load():
    """The kernels' ctypes library, built first if needed. Fills
    ``build_info`` with the build's seconds (0 when reused), the
    compiler's register and shared-memory report and nvcc's version line."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(version.encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"
    so = out_dir / "libagtorch.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # nvcc reads a file's kind from its extension: keep ".o" last
        objs = [out_dir / f"{src.stem}.{os.getpid()}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        failed = []
        for src, proc in zip(sources, procs):
            out = proc.communicate()[0]
            log += f"== {src.name}\n{out}"
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = out_dir / f"libagtorch.{os.getpid()}.so"
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp)]
                             + [str(o) for o in objs], capture_output=True,
                             text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{log}")
        os.replace(tmp, so)
        for obj in objs:
            obj.unlink()
    build_info.update(seconds=time.perf_counter() - t0, log=log,
                      path=str(so), nvcc=version.strip().splitlines()[-1])
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ag_error_string.argtypes = [ctypes.c_int]
    lib.ag_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = _lib.ag_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
