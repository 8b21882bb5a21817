"""Device milliseconds a frame of the convolution and matrix-product
kernels (cuDNN, cuBLAS and CUTLASS), the heads' and LPIPS' together."""

PATTERNS = ("conv", "gemm", "gemv", "xmma", "cutlass", "cudnn", "winograd",
            "fft", "implicit", "dgrad", "wgrad", "sgemm", "cublas")
# the port's own kernels and PyTorch's elementwise ones are not counted
EXCLUDE = ("fir_kernel", "blend_", "tile_order", "expand_pairs",
           "elementwise", "reduce_kernel", "Memcpy", "Memset")


def match(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in PATTERNS) and not any(
        x.lower() in low for x in EXCLUDE)


def read(m):
    if m.trace is None or not m.traced_frames:
        return None
    s = m.trace.device_s(match)
    return 1e3 * s / m.traced_frames if s > 0 else None
