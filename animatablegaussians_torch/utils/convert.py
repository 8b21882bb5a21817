"""Carry the JAX package's parameters across to the port.

Adam's state needs no carrying where both packages start it from zero
moments.

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

``gaussian_params_from_jax`` makes a port ``GaussianParams`` of a standalone
JAX ``GaussianParams`` (numpy leaves), and ``adam_state_from_optax`` loads
optax's Adam moments for it into a ``torch.optim.Adam``.

``lpips_from_jax`` and ``inception_from_jax`` carry the LPIPS and the
Inception trunk's weights across; ``dual_styleunet_v2_state``,
``swgan_unet_state``, ``style_generator_state`` and ``discriminator_state``
the StyleGAN2 family's (the inverses of the JAX package's
``import_dual_styleunet_v2``, ``import_swgan_unet``,
``import_style_generator`` and ``import_discriminator``);
``feature2d_state`` the 2D feature fields' (``models/feature2d``).
"""

from __future__ import annotations

import numpy as np
import torch

from animatablegaussians_torch.models.gaussian_model import GaussianParams


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _conv_w(a):   # (kh, kw, in, out) -> (out, in, kh, kw)
    return _t(np.asarray(a).transpose(3, 2, 0, 1))


def _lin_w(a):    # (in, out) -> (out, in)
    return _t(np.asarray(a).T)


def _style_mlp(sd, layers):
    for i, lp in enumerate(layers):
        sd[f"style.{i + 1}.weight"] = _lin_w(lp["weight"])
        sd[f"style.{i + 1}.bias"] = _t(lp["bias"])


def _conv_layer(sd, k, lp, downsample):
    ci = 1 if downsample else 0
    sd[f"{k}.{ci}.weight"] = _conv_w(lp["conv"]["weight"])
    sd[f"{k}.{ci + 1}.bias"] = _t(lp["act_bias"])


def _modulated(sd, k, mp):
    sd[f"{k}.weight"] = _conv_w(mp["weight"])[None]
    sd[f"{k}.modulation.weight"] = _lin_w(mp["modulation"]["weight"])
    sd[f"{k}.modulation.bias"] = _t(mp["modulation"]["bias"])


def _styled_conv(sd, k, sp):
    _modulated(sd, f"{k}.conv", sp["conv"])
    sd[f"{k}.noise.weight"] = _t(sp["noise_weight"]).reshape(1)
    sd[f"{k}.activate.bias"] = _t(sp["act_bias"])


def _to_rgb(sd, k, rp):
    _modulated(sd, f"{k}.conv", rp["conv"])
    sd[f"{k}.bias"] = _t(rp["bias"]).reshape(1, -1, 1, 1)


def _noises(sd, noises):
    for i, n in enumerate(noises):
        sd[f"noises.noise_{i}"] = _t(np.asarray(n).transpose(0, 3, 1, 2))


def dual_styleunet_state(p: dict, branches=("1", "2")) -> dict:
    """One JAX DualStyleUNet parameter tree -> the port module's keys; the
    decoder branches are ``convs<b>`` / ``to_rgbs<b>`` for each ``b`` of
    ``branches``."""
    sd = {}
    _style_mlp(sd, p["style"])
    _conv_layer(sd, "conv_in", p["conv_in"], True)
    for i, fp in enumerate(p["from_rgbs"]):
        _conv_layer(sd, f"from_rgbs.{i}.conv", fp["conv"], False)
    for i, cp in enumerate(p["cond_convs"]):
        _conv_layer(sd, f"cond_convs.{i}.conv1", cp["conv1"], False)
        _conv_layer(sd, f"cond_convs.{i}.conv2", cp["conv2"], True)
    for i, cp in enumerate(p["comb_convs"]):
        _conv_layer(sd, f"comb_convs.{i}", cp, False)
    for branch in branches:
        for i, sp in enumerate(p[f"convs{branch}"]):
            _styled_conv(sd, f"convs{branch}.{i}", sp)
        for i, rp in enumerate(p[f"to_rgbs{branch}"]):
            _to_rgb(sd, f"to_rgbs{branch}.{i}", rp)
    _noises(sd, p["noises"])
    return sd


def dual_styleunet_v2_state(p: dict) -> dict:
    """A JAX ``DualStyleUNetV2`` tree, any mode -> the port module's keys:
    v1's layout (the modes differ only in stage counts and widths, which
    the tree's shapes carry), as ``import_dual_styleunet_v2`` reads it."""
    return dual_styleunet_state(p)


def swgan_unet_state(p: dict) -> dict:
    """A JAX ``SWGANUnet`` tree -> the port module's keys: v2's layout
    with the one ``convs`` / ``to_rgbs`` branch."""
    return dual_styleunet_state(p, branches=("",))


def style_generator_state(p: dict) -> dict:
    """A JAX ``StyleGenerator`` tree -> the port module's keys, the inverse
    of ``import_style_generator`` (checkpoint.py:258-299)."""
    sd = {}
    _style_mlp(sd, p["style"])
    sd["input.input"] = _t(np.asarray(p["input"]).transpose(0, 3, 1, 2))
    _styled_conv(sd, "conv1", p["conv1"])
    _to_rgb(sd, "to_rgb1", p["to_rgb1"])
    for i, sp in enumerate(p["convs"]):
        _styled_conv(sd, f"convs.{i}", sp)
    for i, rp in enumerate(p["to_rgbs"]):
        _to_rgb(sd, f"to_rgbs.{i}", rp)
    _noises(sd, p["noises"])
    return sd


def discriminator_state(p: dict) -> dict:
    """A JAX ``Discriminator`` tree -> the port module's keys, the inverse
    of ``import_discriminator`` (checkpoint.py:216-256). The JAX net
    flattens its 4x4 map NHWC, the port NCHW as the reference does, so
    ``final_linear.0``'s columns go back from (h, w, c) to (c, h, w)
    order (the importer's reorder at :241-250, undone)."""
    sd = {}
    for i, fp in enumerate(p["from_rgbs"] + [p["final_from_rgb"]]):
        _conv_layer(sd, f"from_rgbs.{i}.conv", fp["conv"], False)
    for i, cp in enumerate(p["convs"]):
        _conv_layer(sd, f"convs.{i}.conv1", cp["conv1"], False)
        _conv_layer(sd, f"convs.{i}.conv2", cp["conv2"], True)
    _conv_layer(sd, "final_conv", p["final_conv"], False)
    lin0, lin1 = p["final_linear"]
    w0 = np.asarray(lin0["weight"]).T                     # (out, h*w*c)
    c = w0.shape[1] // 16
    sd["final_linear.0.weight"] = _t(
        w0.reshape(-1, 4, 4, c).transpose(0, 3, 1, 2).reshape(-1, c * 16))
    sd["final_linear.0.bias"] = _t(lin0["bias"])
    sd["final_linear.1.weight"] = _lin_w(lin1["weight"])
    sd["final_linear.1.bias"] = _t(lin1["bias"])
    for i, lp in enumerate(p.get("mapping", [])):
        sd[f"mapping.{i}.weight"] = _lin_w(lp["weight"])
        sd[f"mapping.{i}.bias"] = _t(lp["bias"])
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


def gaussian_params_from_jax(p_np) -> GaussianParams:
    """A JAX ``GaussianParams`` with numpy leaves -> the port
    ``GaussianParams``, on the CPU."""
    return GaussianParams(**{f: _t(getattr(p_np, f))
                             for f in GaussianParams.FIELDS})


def adam_state_from_optax(optimizer, g, count, mu, nu) -> None:
    """Set ``optimizer``'s (a ``torch.optim.Adam`` over ``g``'s parameters)
    state to optax's ``ScaleByAdamState``: ``count`` steps taken and the
    moments ``mu`` and ``nu`` (JAX ``GaussianParams`` with numpy leaves)."""
    for f in g.FIELDS:
        p = getattr(g, f)
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": _t(getattr(mu, f)).to(p.device),
            "exp_avg_sq": _t(getattr(nu, f)).to(p.device)}


def feature2d_state(p) -> dict:
    """JAX ``models/feature2d`` parameters -> the port's state dict:
    ``TriPlaneFeature`` / ``UVFeature`` ({"fmap": (1, S, S, C)} -> (1, C, S,
    S)), ``ConvStack`` (a list of {"w"}) or ``UNet5`` (a dict of {"w"[,
    "b"]}). A conv's HWIO weight becomes (out, in, kh, kw); a transposed
    conv's (``deconv1``-``deconv4``, JAX ``_deconv``: a convolution of the
    lhs-dilated input with the flipped kernel) becomes
    ``ConvTranspose2d``'s (in, out, kh, kw) without the flip, which the
    transposed convolution applies itself."""
    if isinstance(p, dict) and "fmap" in p:
        return {"fmap": _t(np.asarray(p["fmap"]).transpose(0, 3, 1, 2))}
    if isinstance(p, (list, tuple)):
        return {f"convs.{i}.weight": _conv_w(cp["w"])
                for i, cp in enumerate(p)}
    sd = {}
    for name, cp in p.items():
        if name in ("deconv1", "deconv2", "deconv3", "deconv4"):
            sd[f"{name}.weight"] = _t(np.asarray(cp["w"]).transpose(
                2, 3, 0, 1))
        else:
            sd[f"{name}.weight"] = _conv_w(cp["w"])
        if "b" in cp:
            sd[f"{name}.bias"] = _t(cp["b"])
    return sd
