"""Carry the JAX package's parameters across to the port.

Adam's state needs no carrying: both packages start it from zero moments.

``params_from_jax`` is the inverse of
``animatablegaussians_tpu/training/checkpoint.py::import_avatar_params``
(checkpoint.py:108-216): it takes the JAX ``AvatarNet`` parameter tree as
nested dicts/lists of numpy arrays (``cano_gaussian`` flattened to a dict of
its fields) and returns the port ``AvatarNet``'s ``state_dict``, whose
CNN keys are the reference torch checkpoint's names. Layouts: HWIO conv ->
(out, in, kh, kw); (in, out) linear -> (out, in); modulated conv ->
(1, out, in, k, k); NHWC noise -> NCHW.

``template_params_from_jax`` takes the JAX ``TemplateNet.init`` tree
(``geo_mlp`` and ``tex_mlp`` lists of {weight (in, out), bias, g},
``density.beta``, ``left_hand`` / ``right_hand`` lists) and returns the
port ``TemplateNet``'s ``state_dict``.

``lpips_from_jax`` and ``inception_from_jax`` carry the LPIPS and the
Inception trunk's weights across.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _conv_w(a):   # (kh, kw, in, out) -> (out, in, kh, kw)
    return _t(np.asarray(a).transpose(3, 2, 0, 1))


def _lin_w(a):    # (in, out) -> (out, in)
    return _t(np.asarray(a).T)


def dual_styleunet_state(p: dict) -> dict:
    """One JAX DualStyleUNet parameter tree -> the port module's keys."""
    sd = {}
    for i, lp in enumerate(p["style"]):
        sd[f"style.{i + 1}.weight"] = _lin_w(lp["weight"])
        sd[f"style.{i + 1}.bias"] = _t(lp["bias"])

    def conv_layer(k, lp, downsample):
        ci = 1 if downsample else 0
        sd[f"{k}.{ci}.weight"] = _conv_w(lp["conv"]["weight"])
        sd[f"{k}.{ci + 1}.bias"] = _t(lp["act_bias"])

    def modulated(k, mp):
        sd[f"{k}.weight"] = _conv_w(mp["weight"])[None]
        sd[f"{k}.modulation.weight"] = _lin_w(mp["modulation"]["weight"])
        sd[f"{k}.modulation.bias"] = _t(mp["modulation"]["bias"])

    conv_layer("conv_in", p["conv_in"], True)
    for i, fp in enumerate(p["from_rgbs"]):
        conv_layer(f"from_rgbs.{i}.conv", fp["conv"], False)
    for i, cp in enumerate(p["cond_convs"]):
        conv_layer(f"cond_convs.{i}.conv1", cp["conv1"], False)
        conv_layer(f"cond_convs.{i}.conv2", cp["conv2"], True)
    for i, cp in enumerate(p["comb_convs"]):
        conv_layer(f"comb_convs.{i}", cp, False)
    for branch in ("1", "2"):
        for i, sp in enumerate(p[f"convs{branch}"]):
            k = f"convs{branch}.{i}"
            modulated(f"{k}.conv", sp["conv"])
            sd[f"{k}.noise.weight"] = _t(sp["noise_weight"]).reshape(1)
            sd[f"{k}.activate.bias"] = _t(sp["act_bias"])
        for i, rp in enumerate(p[f"to_rgbs{branch}"]):
            k = f"to_rgbs{branch}.{i}"
            modulated(f"{k}.conv", rp["conv"])
            sd[f"{k}.bias"] = _t(rp["bias"]).reshape(1, -1, 1, 1)
    for i, n in enumerate(p["noises"]):
        sd[f"noises.noise_{i}"] = _t(np.asarray(n).transpose(0, 3, 1, 2))
    return sd


def params_from_jax(params_np: dict) -> dict:
    """JAX AvatarNet params (numpy leaves) -> port AvatarNet state_dict."""
    sd = {}
    for name in ("color_net", "position_net", "other_net"):
        for k, v in dual_styleunet_state(params_np[name]).items():
            sd[f"{name}.{k}"] = v
    if "viewdir_net" in params_np:
        vp = params_np["viewdir_net"]
        for idx, conv in (("0", "conv1"), ("2", "conv2")):
            sd[f"viewdir_net.{idx}.weight"] = _conv_w(vp[conv]["weight"])
            sd[f"viewdir_net.{idx}.bias"] = _t(vp[conv]["bias"])
    for k, v in params_np["cano_gaussian"].items():
        sd[f"cano_gaussian.{k}"] = _t(v)
    return sd


def lpips_from_jax(params_np: dict) -> dict:
    """JAX LPIPS params (``training/lpips.py`` ``convs`` of HWIO weights
    and biases, ``lins`` of (C,) vectors; numpy leaves) -> the port
    ``training.lpips.LPIPS`` state dict: the inverse of the layout
    ``load_torch_weights`` reads (lpips.py:71-109)."""
    sd = {}
    for i, cp in enumerate(params_np["convs"]):
        sd[f"convs.{i}.weight"] = _conv_w(cp["weight"])
        sd[f"convs.{i}.bias"] = _t(cp["bias"])
    for i, lin in enumerate(params_np["lins"]):
        sd[f"lins.{i}"] = _t(lin)
    return sd


def mlp_state(layers, prefix: str) -> dict:
    """A JAX MLP's layer list -> ``<prefix>layers.<i>.{weight,bias,g}``."""
    sd = {}
    for i, lp in enumerate(layers):
        sd[f"{prefix}layers.{i}.weight"] = _lin_w(lp["weight"])
        sd[f"{prefix}layers.{i}.bias"] = _t(lp["bias"])
        if "g" in lp:
            sd[f"{prefix}layers.{i}.g"] = _t(lp["g"])
    return sd


def template_params_from_jax(params_np: dict) -> dict:
    """JAX TemplateNet params (numpy leaves) -> port TemplateNet
    state_dict."""
    sd = {"density.beta": _t(params_np["density"]["beta"])}
    sd.update(mlp_state(params_np["geo_mlp"], "geo_mlp."))
    sd.update(mlp_state(params_np["tex_mlp"], "tex_mlp."))
    for hand in ("left_hand", "right_hand"):
        sd.update(mlp_state(params_np[hand], f"{hand}.tex_mlp."))
    return sd


def inception_from_jax(params_np: dict) -> dict:
    """JAX ``eval/fid.InceptionV3Features.params`` (``{name: {w (HWIO),
    b}}``, BatchNorm folded; numpy leaves) -> the port
    ``eval.fid.InceptionV3Features`` state dict (``<name>.weight`` (out,
    in, kh, kw), ``<name>.bias``)."""
    sd = {}
    for name, p in params_np.items():
        sd[f"{name}.weight"] = _conv_w(p["w"])
        sd[f"{name}.bias"] = _t(p["b"])
    return sd
