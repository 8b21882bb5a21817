"""The work the avatar's frames need, counted from the configuration's
shapes: the FLOPs of the heads, the view-direction encoder and LPIPS, the
FIR calls with their bytes and operations, and the blend's bytes; with
the published peaks of one H100 to hold them against.

Counts follow the networks of ``reference/``: a convolution costs 2 Cin
Cout k^2 FLOPs an output pixel, a transposed one 2 Cin Cout k^2 an input
pixel, a linear layer 2 in out; a backward pass costs twice its forward
(input and weight gradients). Elementwise work, the FIRs' operations, the
splat and the pixel losses are left out of the FLOPs: they are small
beside the convolutions, so the model FLOPs bound the work from below.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TILE = 16
BLUR_TAPS = 4


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least seconds one H100 needs to move ``n_bytes`` through its
    memory and do ``n_ops`` FP32 operations."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS)


def _channels(mult: int, channel_max: int) -> dict:
    c = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * mult, 128: 128 * mult,
         256: 64 * mult, 512: 32 * mult, 1024: 16 * mult, 2048: 16 * mult}
    return {k: min(v, channel_max) for k, v in c.items()}


def conv(cin: int, cout: int, k: int, out_hw: int) -> float:
    return 2.0 * cin * cout * k * k * out_hw * out_hw


def head_layers(model: dict, out_ch: int):
    """One DualStyleUNet's work for one frame: (FLOPs of its convolutions
    and transposed convolutions per frame, FLOPs of its linear layers per
    call, FIR calls as (channels, in_h, in_w, out_h, out_w, up, down,
    input carries a gradient))."""
    S_out = int(model["map_h"])
    S_in = S_out // 2
    ch = _channels(int(model["channel_multiplier"]), int(model["channel_max"]))
    mid = int(math.log2(int(model["middle_size"])))
    sd = int(model["style_dim"])
    convs = lin = 0.0
    firs = []
    lin += int(model["n_mlp"]) * 2.0 * sd * sd           # mapping MLP
    enc_in = ch[S_in // 2]
    # conv_in: blur (pad 2, 2) of the pose map, 3x3 stride 2
    firs.append((3, S_in, S_in, S_in + 1, S_in + 1, 1, 1, False))
    convs += conv(3, enc_in, 3, S_in // 2)
    comb = [(enc_in * 2, enc_in, S_in // 2)]
    c_in, img = enc_in, S_in
    for i in range(int(math.log2(S_in)) - 2, mid - 1, -1):
        res = 2 ** (i + 1)                     # the level's input resolution
        c_out = ch[2 ** i]
        firs.append((3, img, img, img // 2, img // 2, 1, 2, False))
        img //= 2
        convs += conv(3, c_in, 1, res)                    # FromRGB
        convs += conv(c_in, c_in, 3, res)                 # ConvBlock conv1
        firs.append((c_in, res, res, res + 1, res + 1, 1, 1, True))
        convs += conv(c_in, c_out, 3, res // 2)           # conv2, stride 2
        comb.append((c_out * 2 if i > mid else c_out, c_out, res // 2))
        c_in = c_out
    n_stages = int(math.log2(S_out)) - mid - 1
    chans = [ch[2 ** (mid + s)] for s in range(n_stages + 1)]
    for _branch in range(2):
        for s in range(n_stages):
            r = 2 ** (mid + s)
            if s < len(comb):
                cin_c, cout_c, _ = comb[-1 - s]
                convs += conv(cin_c, cout_c, 3, r)
            a, b = chans[s], chans[s + 1]
            # up: 3x3 transposed, stride 2, on r x r; blur of (2r + 1)^2
            convs += 2.0 * a * b * 9 * r * r
            firs.append((b, 2 * r + 1, 2 * r + 1, 2 * r, 2 * r, 1, 1, True))
            convs += conv(b, b, 3, 2 * r)
            convs += conv(b, out_ch * 4, 1, 2 * r)         # ToRGB
            if s:
                # the skip's wavelet upsample: pixel space at 2r -> 4r
                firs.append((out_ch, 2 * r, 2 * r, 4 * r, 4 * r, 2, 1, True))
            lin += 2.0 * sd * a + 2.0 * sd * b + 2.0 * sd * b  # modulations
    return convs, lin, firs


def viewdir_flops(model: dict) -> float:
    """The view-direction encoder on the front and the back half map."""
    h = int(model["map_h"]) // 2
    return 2 * (conv(1, 64, 4, h // 2) + conv(64, 128, 4, h // 4))


def vgg_flops(size: int) -> float:
    """One VGG16 trunk forward on a size^2 image (LPIPS' five stages)."""
    total, c_in, res = 0.0, 3, size
    for c in (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512):
        if c == "M":
            res //= 2
            continue
        total += conv(c_in, c, 3, res)
        c_in = c
    return total


HEADS = (("position_net", 3), ("other_net", 8), ("color_net", 3))


def frame_flops(cfg: dict, train: bool, batch: int = 1) -> float:
    """Model FLOPs a frame: the three heads (their linear layers run once
    a call of ``batch`` frames) and the view encoder, forward; with
    ``train`` their backward at twice the forward and LPIPS on the crop
    (the image's and the target's forward, the image's input gradient)."""
    m = cfg["model"]
    total = viewdir_flops(m)
    for _, out_ch in HEADS:
        convs, lin, _ = head_layers(m, out_ch)
        total += convs + lin / batch
    if not train:
        return total
    total *= 3
    return total + 3 * vgg_flops(int(cfg["train"]["patch_size"]))


def fir_calls(cfg: dict, train: bool) -> list:
    """The FIR calls of a frame as (bytes, operations): each forward call,
    and with ``train`` each first derivative of a call whose input carries
    a gradient, which reads the output's shape and writes the input's."""
    out = []
    for _, out_ch in HEADS:
        for c, ih, iw, oh, ow, up, down, grad in head_layers(
                cfg["model"], out_ch)[2]:
            n_bytes = 4.0 * c * (ih * iw + oh * ow)
            ops = 2.0 * c * oh * ow * 2 * BLUR_TAPS / up
            out.append((n_bytes, ops))
            if train and grad:
                out.append((n_bytes, 2.0 * c * ih * iw * 2 * BLUR_TAPS / down))
    return out


def fir_bound_s(cfg: dict, train: bool) -> float:
    """The least seconds the FIR calls of a frame need."""
    return sum(bound_s(b, o) for b, o in fir_calls(cfg, train))


def blend_bytes(n_pts: int, n_pairs: int, img_w: int, img_h: int,
                backward: bool = False) -> float:
    """The bytes a blend must move: the packed rows, the pair list and the
    tile ranges in, colour, depth and transmittance out; the backward
    reads the rows and writes their gradient, and reads the outputs and
    their cotangents."""
    gx, gy = -(-img_w // TILE), -(-img_h // TILE)
    rows = n_pts * 40 * (2 if backward else 1)
    pix = img_w * img_h * 5 * 4 * (2 if backward else 1)
    return rows + n_pairs * 4 + (gx * gy + 1) * 8 + pix
