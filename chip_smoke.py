"""Card checks of the PyTorch / CUDA port in one command: the card, the
kernels' build, then every ``gpu``-marked test of the port's test files.

    python3 chip_smoke.py

Needs a CUDA card and ``nvcc`` (CUDA_HOME or PATH). Prints the card's name
and power limit, builds ``csrc/*.cu`` (``utils/cuda_build.py``: one
``nvcc`` for sm_90a per source) with each kernel's ptxas register line,
then runs ``pytest -m gpu tests/test_torch_*.py`` in a child process
and exits with its code; this process imports neither JAX nor the JAX
package. One slice's checks alone: ``python -m pytest -m gpu tests/<file>
-q``. Timing is the benchmark's (``portbench/run.py --trace 1``).

The H100 figures below are the benchmark's too
(``portbench/yardstick/work.py``, held equal by
``portbench/tests/test_yardstick.py``).
"""

from __future__ import annotations

import glob
import os
import subprocess
import sys

# H100 SXM (NVIDIA data sheet): HBM3 rate and FP32 rate outside the tensor
# cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound(n_bytes: float, n_ops: float = 0.0):
    """(bound ms, what bounds it) for work that must move ``n_bytes`` and
    do ``n_ops`` FP32 operations on one H100."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def blend_bytes(n_pts: int, n_pairs: int, gx: int, gy: int, img_w: int,
                img_h: int) -> int:
    """The bytes the forward blend must move: rows, gids and tile ranges in;
    colour, depth and T_final out."""
    return (n_pts * 40 + n_pairs * 4 + (gx * gy + 1) * 8
            + img_w * img_h * 5 * 4)


def main() -> int:
    import torch

    from animatablegaussians_torch.utils import cuda_build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{smi.stdout.strip() or smi.stderr.strip()}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    cuda_build.load()
    info = cuda_build.build_info
    print(f"[build] {info['seconds']:.2f} s -> {info['path']}")
    for ln in info["log"].splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            print(f"[build] {ln.strip()}")
    sys.stdout.flush()
    # the tests run in a child process: they hold the port to the JAX
    # package, which this script never loads
    root = os.path.dirname(os.path.abspath(__file__))
    files = sorted(glob.glob(os.path.join("tests", "test_torch_*.py"),
                             root_dir=root))
    rc = subprocess.call([sys.executable, "-m", "pytest", "-m", "gpu",
                          *files, "-q", "-p", "no:cacheprovider"], cwd=root)
    jax_mods = sorted({"jax", "animatablegaussians_tpu"} & set(sys.modules))
    if jax_mods:
        print(f"chip_smoke: this process imported {jax_mods}",
              file=sys.stderr)
        return 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
