"""The frozen yardsticks: the FLOP counter, the FIR call list, the blend's
bytes and the peaks, against hand-worked counts, the port's own calls at a
small size and ``chip_smoke.py``'s formulas."""

import json
import math
import os

import pytest
import torch

from portbench.yardstick import work

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(map_h=64, channel_max=32, channel_multiplier=2, middle_size=8,
             style_dim=512, n_mlp=2)


def _cfg(**model):
    with open(os.path.join(BENCH, "configs", "avatarrex_zzr.json")) as f:
        cfg = json.load(f)
    cfg["model"].update(model)
    return cfg


def test_conv_counts_by_hand():
    # 3 -> 8 channels, 3x3, on a 16x16 output: 2 * 3 * 8 * 9 * 256 FLOPs
    assert work.conv(3, 8, 3, 16) == 110_592
    # a two-layer stack 3 -> 8 -> 8 at 16x16 and a 1x1 8 -> 4 at 8x8
    stack = work.conv(3, 8, 3, 16) + work.conv(8, 8, 3, 16) \
        + work.conv(8, 4, 1, 8)
    assert stack == 110_592 + 294_912 + 4_096


def test_vgg_by_hand():
    # VGG16 on 32^2: 13 convolutions over five resolutions
    want = 2 * 9 * (3 * 64 * 1024 + 64 * 64 * 1024 + 64 * 128 * 256
                    + 128 * 128 * 256 + 128 * 256 * 64 + 2 * 256 * 256 * 64
                    + 256 * 512 * 16 + 2 * 512 * 512 * 16
                    + 3 * 512 * 512 * 4)
    assert work.vgg_flops(32) == want


def test_head_flops_match_the_profiler_count_of_the_port():
    from torch.utils.flop_counter import FlopCounterMode

    from animatablegaussians_torch.models.styleunet import DualStyleUNet
    m = dict(_cfg()["model"], **SMALL)
    for out_ch in (3, 8):
        convs, lin, _ = work.head_layers(m, out_ch)
        net = DualStyleUNet(inp_size=32, inp_ch=3, out_ch=out_ch,
                            out_size=64, style_dim=512, n_mlp=2,
                            channel_max=32,
                            generator=torch.Generator().manual_seed(0))
        style = torch.ones(1, 512)
        for batch in (1, 3):
            with FlopCounterMode(display=False) as fc:
                net(style, torch.rand(batch, 32, 32, 3))
            assert fc.get_total_flops() == pytest.approx(
                batch * convs + lin, rel=1e-12)


def test_fir_calls_match_the_port_s_launches():
    from animatablegaussians_torch.models.styleunet import DualStyleUNet
    from animatablegaussians_torch.ops import fir
    m = dict(_cfg()["model"], **SMALL)
    seen = []
    saved = fir._launch

    def launch(x, kv, kh, up, down, pad):
        y = saved(x, kv, kh, up, down, pad)
        seen.append((x.shape[1], *x.shape[2:], *y.shape[2:], up, down,
                     x.requires_grad))
        return y

    fir._launch = launch
    try:
        for out_ch in (3, 8):
            seen.clear()
            net = DualStyleUNet(inp_size=32, inp_ch=3, out_ch=out_ch,
                                out_size=64, style_dim=512, n_mlp=2,
                                channel_max=32,
                                generator=torch.Generator().manual_seed(0))
            net(torch.ones(1, 512), torch.rand(1, 32, 32, 3))
            want = work.head_layers(m, out_ch)[2]
            assert sorted(s[:-1] for s in seen) == sorted(w[:-1]
                                                          for w in want)
            # in training every call on a feature map carries a gradient,
            # those on the pose map none
            assert sum(w[-1] for w in want) == sum(
                1 for w in want if w[0] != 3 or w[5] != 1 or w[6] != 2) - 1
    finally:
        fir._launch = saved


def test_fir_call_counts_at_full_width():
    calls = work.fir_calls(_cfg(), train=True)
    fwd = sum(len(work.head_layers(_cfg()["model"], c)[2])
              for _, c in work.HEADS)
    assert fwd == 99 and len(calls) == 99 + 81


def test_blend_bytes_match_chip_smoke():
    import chip_smoke
    n_pts, n_pairs, w, h = 531_520, 1_291_771, 1500, 2048
    gx, gy = -(-w // 16), -(-h // 16)
    assert work.blend_bytes(n_pts, n_pairs, w, h) == chip_smoke.blend_bytes(
        n_pts, n_pairs, gx, gy, w, h)
    bwd = (n_pts * 40 * 2 + n_pairs * 4 + (gx * gy + 1) * 8
           + w * h * 5 * 4 * 2)
    assert work.blend_bytes(n_pts, n_pairs, w, h, backward=True) == bwd
    # PERF.md's 0.051 ms bound of the backward blend
    assert 1e3 * work.bound_s(bwd) == pytest.approx(0.051, abs=5e-4)
    assert work.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert work.FP32_FLOPS == chip_smoke.FP32_OPS_PER_S
    assert work.bound_s(1e9, 1.0) == chip_smoke.bound(1e9, 1.0)[0] / 1e3


def test_fir_bytes_match_chip_smoke_s_count():
    # chip_smoke counts a call's bytes as (input + output elements) * 4
    cfg = _cfg()
    for (c, ih, iw, oh, ow, up, down, _), (nb, _) in zip(
            work.head_layers(cfg["model"], 3)[2], work.fir_calls(cfg, False)):
        assert nb == (c * ih * iw + c * oh * ow) * 4


def test_full_width_flops():
    cfg = _cfg()
    head = work.head_layers(cfg["model"], 3)
    assert head[0] == pytest.approx(5.858e11, rel=1e-3)
    other = work.head_layers(cfg["model"], 8)
    render = work.frame_flops(cfg, train=False)
    assert math.isclose(render, 2 * (head[0] + head[1]) + other[0] + other[1]
                        + work.viewdir_flops(cfg["model"]), rel_tol=1e-12)
    assert work.frame_flops(cfg, True) == pytest.approx(
        3 * render + 3 * work.vgg_flops(512), rel=1e-12)
