"""Parameters into the port: from the JAX package's flax tree, or drawn from a
seed.

The port names its modules as the JAX package's flax modules are named, so a
flax path ``encoder/block_0/res0/conv1/v`` is the port's state-dict key
``encoder.block_0.res0.conv1.v``. Only the layouts differ:

  * conv ``v``: flax ``(k, in, out)`` -> port ``(out, in, k)``;
  * transposed conv (the decoder blocks' ``up``) ``v``: ``(in, out, k)`` in
    both;
  * 1x1 projection (``in_proj``/``out_proj``) ``v``: ``(in, out)`` in both;
  * ``g``, ``bias``, Snake ``alpha`` and ``codebook`` are unchanged; ``g``
    follows its layer's grouping (per out-channel, per IN-channel for a
    transposed conv).

``DAC_MOE``'s router is a flax ``Dense``: its ``kernel (in, Nq)`` becomes
the port's ``Linear`` ``weight (Nq, in)``, its ``bias`` stays. Per-stage
codebook widths need no rule (each stage keeps its own shapes), nor does
``DenoisingBlock`` (``res{i}.*``, ``snake``, ``conv``: the conv rules).

A folded tree (``vrvq_tpu.infer.fast.make_inference_model``) converts too:
its ``w`` takes ``v``'s layout change, and a bfloat16 leaf stays bfloat16,
for the port's folded modules (``nn/fold.py``).

A reference-layout state dict (the PyTorch DAC_VRVQ's names and shapes, as
the JAX package's ``export_torch_state_dict`` and ``save_torch_checkpoint``
write it) converts by ``state_dict_from_reference``, VBR, CBR or
``DAC_MOE`` (whose ``quantizer.router.{weight, bias}`` keep their layout).

The discriminator converts likewise (``discriminator_state_dict_from_jax``):
a 2-D conv ``v`` is flax ``(kh, kw, in, out)``, the port's ``(out, in, kh,
kw)``; MSD's 1-D conv ``v`` flax ``(k, in / groups, out)``, the port's
``(out, in / groups, k)``. A gradient tree has its parameters' layout, so the
same two functions map ``jax.grad``'s trees onto the port's keys, for
comparing gradients leaf by leaf. From and to the reference's layout
(``discriminators.{i}.convs.{j}.0``, ``band_convs.{b}.{j}.0``,
``conv_post``, the sub-discriminators numbered MPD, MSD, MRD in turn):
``discriminator_state_dict_from_reference`` and
``discriminator_state_dict_to_reference``.

The exports, ``state_dict_to_reference`` and
``discriminator_state_dict_to_reference`` (the JAX package's
``export_torch_state_dict`` and ``export_torch_discriminator_state_dict``),
read a live model: a folded one carries no weight-norm split and raises.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch

from .models.wn_dense import WNDense1x1
from .models.quantize import VectorQuantize
from .nn.layers import Snake1d, WNConv1d, WNConvTranspose1d


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for name, node in tree.items():
        key = f"{prefix}{name}"
        if isinstance(node, Mapping):
            out.update(_flatten(node, key + "."))
        else:
            out[key] = np.asarray(node)
    return out


def _tensor(value: np.ndarray) -> torch.Tensor:
    """float32, or bfloat16 for a bfloat16 leaf (numpy has no such dtype of
    its own: the leaf's bits are taken as they are)."""
    if value.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(value).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.tensor(np.ascontiguousarray(value, np.float32))


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``DAC_VRVQ``'s or ``DAC_MOE``'s parameter tree (numpy leaves,
    with or without the top-level ``params`` key), live or folded -> the
    port's ``state_dict``."""
    tree = params.get("params", params)
    sd = {}
    for key, value in _flatten(tree).items():
        parts = key.split(".")
        if parts[-2:] == ["router", "kernel"]:  # Dense (in, Nq) -> Linear
            sd[".".join(parts[:-1] + ["weight"])] = _tensor(value.T)
            continue
        transposed_conv = parts[-2:-1] == ["up"]
        if parts[-1] in ("v", "w") and value.ndim == 3 and not transposed_conv:
            value = np.transpose(value, (2, 1, 0))  # (k, in, out) -> (out, in, k)
        sd[key] = _tensor(value)
    return sd


# a residual unit's layers in the reference's Sequential
_UNIT = {"snake1": 0, "conv1": 1, "snake2": 2, "conv2": 3}
_LEAF = {"v": "weight_v", "g": "weight_g", "bias": "bias", "alpha": "alpha",
         "codebook": "codebook.weight", "weight": "weight"}


def _reference_module(path: str, n_enc: int, n_dec: int) -> str:
    """The reference's module path of one of the port's (``encoder.block_1.
    res2.conv1`` -> ``encoder.block.2.block.2.block.1``)."""
    rules = [
        (r"encoder\.in_conv", lambda m: "encoder.block.0"),
        (r"encoder\.block_(\d+)\.res(\d)\.(\w+)", lambda m: (
            f"encoder.block.{int(m[1]) + 1}.block.{m[2]}.block.{_UNIT[m[3]]}")),
        (r"encoder\.block_(\d+)\.snake", lambda m: f"encoder.block.{int(m[1]) + 1}.block.3"),
        (r"encoder\.block_(\d+)\.down", lambda m: f"encoder.block.{int(m[1]) + 1}.block.4"),
        (r"encoder\.snake", lambda m: f"encoder.block.{n_enc + 1}"),
        (r"encoder\.out_conv", lambda m: f"encoder.block.{n_enc + 2}"),
        (r"quantizer\.quantizers_(\d+)(\.in_proj|\.out_proj)?",
         lambda m: f"quantizer.quantizers.{m[1]}{m[2] or ''}"),
        (r"quantizer\.router", lambda m: "quantizer.router"),
        (r"quantizer\.imp_subnet\.in_snake", lambda m: "quantizer.imp_subnet.in_block.0"),
        (r"quantizer\.imp_subnet\.in_conv", lambda m: "quantizer.imp_subnet.in_block.1"),
        (r"quantizer\.imp_subnet\.snake_(\d+)", lambda m: f"quantizer.imp_subnet.blocks.{m[1]}.0"),
        (r"quantizer\.imp_subnet\.conv_(\d+)", lambda m: f"quantizer.imp_subnet.blocks.{m[1]}.1"),
        (r"decoder\.in_conv", lambda m: "decoder.model.0"),
        (r"decoder\.block_(\d+)\.snake", lambda m: f"decoder.model.{int(m[1]) + 1}.block.0"),
        (r"decoder\.block_(\d+)\.up", lambda m: f"decoder.model.{int(m[1]) + 1}.block.1"),
        (r"decoder\.block_(\d+)\.res(\d)\.(\w+)", lambda m: (
            f"decoder.model.{int(m[1]) + 1}.block.{int(m[2]) + 2}.block.{_UNIT[m[3]]}")),
        (r"decoder\.snake", lambda m: f"decoder.model.{n_dec + 1}"),
        (r"decoder\.out_conv", lambda m: f"decoder.model.{n_dec + 2}"),
    ]
    for pattern, name in rules:
        m = re.fullmatch(pattern, path)
        if m:
            return name(m)
    raise KeyError(f"no reference name for the module {path!r}")


def state_dict_from_reference(state_dict: Mapping, model) -> Dict[str, torch.Tensor]:
    """A reference-layout ``state_dict`` (tensors or numpy arrays) -> the
    state dict of ``model`` (a live ``DAC_VRVQ`` or ``DAC_MOE``, VBR or
    CBR), each tensor in the port's shape: conv ``weight_v`` keeps its
    layout, a quantizer projection's ``(out, in, 1)`` becomes ``(in, out)``,
    ``weight_g`` and Snake ``alpha`` lose their unit axes. A key of either
    side that the other lacks raises."""
    cfg = model.config
    n_enc, n_dec = len(cfg.encoder_rates), len(cfg.decoder_rates)
    out, used = {}, set()
    for key, param in model.state_dict().items():
        path, leaf = key.rsplit(".", 1)
        ref = f"{_reference_module(path, n_enc, n_dec)}.{_LEAF[leaf]}"
        if ref not in state_dict:
            raise KeyError(f"{ref} (for {key}) is missing from the state dict")
        value = np.asarray(state_dict[ref], np.float32)
        if leaf == "v" and path.endswith(("in_proj", "out_proj")):
            value = value[:, :, 0].T
        out[key] = torch.tensor(np.ascontiguousarray(value).reshape(param.shape))
        used.add(ref)
    extra = sorted(set(state_dict) - used)
    if extra:
        raise KeyError(f"state dict keys the {cfg.model_type} model lacks: {extra[:8]}")
    return out


def _reference_leaf(key: str, value: torch.Tensor, n_enc: int, n_dec: int):
    """A port codec key and tensor -> the reference's key and tensor."""
    path, leaf = key.rsplit(".", 1)
    ref = f"{_reference_module(path, n_enc, n_dec)}.{_LEAF[leaf]}"
    if leaf == "v" and path.endswith(("in_proj", "out_proj")):
        value = value.T[:, :, None]  # (in, out) -> (out, in, 1)
    elif leaf == "g":
        value = value.reshape(-1, 1, 1)
    elif leaf == "alpha":
        value = value.reshape(1, -1, 1)
    return ref, value


def _live(model) -> None:
    folded = [n for n, _ in model.named_parameters() if n.endswith(".w")]
    if folded:
        raise ValueError(
            f"{folded[0]}: a folded model (fast-inference profile) carries no "
            "weight-norm split and cannot be exported; export the live model")


def state_dict_to_reference(model) -> Dict[str, torch.Tensor]:
    """The reference-layout ``state_dict`` of ``model`` (a live ``DAC_VRVQ``
    or ``DAC_MOE``, VBR or CBR), float32 on the CPU: the inverse of
    ``state_dict_from_reference``, key for key and bit for bit. A folded
    model raises."""
    _live(model)
    cfg = model.config
    n_enc, n_dec = len(cfg.encoder_rates), len(cfg.decoder_rates)
    out = {}
    for key, value in model.state_dict().items():
        ref, value = _reference_leaf(key, value.detach(), n_enc, n_dec)
        out[ref] = value.to("cpu", torch.float32).contiguous().clone()
    return out


def _discriminator_reference(discriminator) -> Dict[str, str]:
    """Each port key of ``discriminator``'s state dict -> its reference key."""
    names = {}
    for idx, sub in enumerate(discriminator.names):
        base = f"discriminators.{idx}"
        for key in getattr(discriminator, sub).state_dict():
            conv, leaf = key.rsplit(".", 1)
            m = re.fullmatch(r"conv_(\d+)|band_(\d+)_conv_(\d+)|conv_post", conv)
            if m is None:
                raise KeyError(f"no reference name for {sub}.{key}")
            if m[1] is not None:
                ref = f"{base}.convs.{m[1]}.0"
            elif m[2] is not None:
                ref = f"{base}.band_convs.{m[2]}.{m[3]}.0"
            else:
                ref = f"{base}.conv_post"
            names[f"{sub}.{key}"] = f"{ref}.{_LEAF[leaf]}"
    return names


def discriminator_state_dict_to_reference(discriminator) -> Dict[str, torch.Tensor]:
    """The reference-layout ``state_dict`` of the port's ``Discriminator``
    (MPD, MSD and MRD), float32 on the CPU: conv ``weight_v`` in the port's
    layout, ``weight_g`` with unit axes (``(out, 1, 1)`` a 1-D conv,
    ``(out, 1, 1, 1)`` a 2-D one)."""
    sd = discriminator.state_dict()
    out = {}
    for key, ref in _discriminator_reference(discriminator).items():
        value = sd[key].detach()
        if key.endswith(".g"):
            value = value.reshape(-1, *[1] * (sd[key[:-1] + "v"].ndim - 1))
        out[ref] = value.to("cpu", torch.float32).contiguous().clone()
    return out


def discriminator_state_dict_from_reference(state_dict: Mapping,
                                            discriminator) -> Dict[str, torch.Tensor]:
    """A reference-layout discriminator ``state_dict`` (tensors or numpy
    arrays) -> the state dict of ``discriminator`` (whose ``periods``,
    ``rates`` and ``fft_sizes`` name the reference's sub-discriminators in
    turn). A key of either side that the other lacks raises."""
    out, used = {}, set()
    params = discriminator.state_dict()
    for key, ref in _discriminator_reference(discriminator).items():
        if ref not in state_dict:
            raise KeyError(f"{ref} (for {key}) is missing from the state dict")
        value = np.asarray(state_dict[ref], np.float32)
        out[key] = torch.tensor(np.ascontiguousarray(value).reshape(params[key].shape))
        used.add(ref)
    extra = sorted(set(state_dict) - used)
    if extra:
        raise KeyError(f"state dict keys the discriminator lacks: {extra[:8]}")
    return out


def discriminator_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ``Discriminator``'s parameter (or gradient) tree -> the port's
    ``state_dict``: ``mpd_2.conv_0.v`` and so on, 2-D conv ``v`` transposed
    from ``(kh, kw, in, out)`` to ``(out, in, kh, kw)``, MSD's 1-D conv ``v``
    from ``(k, in / groups, out)`` to ``(out, in / groups, k)``."""
    tree = params.get("params", params)
    sd = {}
    for key, value in _flatten(tree).items():
        if key.endswith(".v") and value.ndim == 4:
            value = np.transpose(value, (3, 2, 0, 1))
        elif key.endswith(".v") and value.ndim == 3:
            value = np.transpose(value, (2, 1, 0))
        sd[key] = _tensor(value)
    return sd


def _uniform(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=gen) * (2.0 * bound) - bound


@torch.no_grad()
def init_params(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw every parameter of ``model`` (the codec or the discriminator) on
    the CPU from ``generator``, as the JAX package initializes: conv and
    projection ``v`` uniform in +-1/sqrt(fan_in), ``g = ||v||`` (so the
    effective weight is ``v``), zero biases, codebooks N(0, 1), Snake
    alpha 1, and ``DAC_MOE``'s router as flax's ``Dense``: the weight from
    a normal of variance 1/fan_in truncated at two standard deviations
    (lecun_normal), a zero bias."""
    from .models.discriminator import WNConv2d

    for m in model.modules():
        if isinstance(m, WNConv2d):
            fan_in = m.v.shape[1] * m.v.shape[2] * m.v.shape[3]
            v = _uniform(m.v.shape, 1.0 / math.sqrt(fan_in), generator)
            m.v.copy_(v)
            m.g.copy_(torch.sqrt(torch.sum(v * v, dim=(1, 2, 3))))
            m.bias.zero_()
        if isinstance(m, (WNConv1d, WNConvTranspose1d)):
            cin = m.v.shape[1] if isinstance(m, WNConv1d) else m.v.shape[0]
            v = _uniform(m.v.shape, 1.0 / math.sqrt(cin * m.kernel_size), generator)
            m.v.copy_(v)
            m.g.copy_(torch.sqrt(torch.sum(v * v, dim=(1, 2))))
            m.bias.zero_()
        elif isinstance(m, WNDense1x1):
            v = _uniform(m.v.shape, 1.0 / math.sqrt(m.v.shape[0]), generator)
            m.v.copy_(v)
            m.g.copy_(torch.sqrt(torch.sum(v * v, dim=0)))
            m.bias.zero_()
        elif isinstance(m, VectorQuantize):
            m.codebook.copy_(torch.randn(m.codebook.shape, generator=generator))
        elif isinstance(m, Snake1d):
            m.alpha.fill_(1.0)
        elif isinstance(m, torch.nn.Linear):
            # lecun_normal: the truncation's 0.8796 restores the variance
            std = 1.0 / math.sqrt(m.in_features) / 0.87962566103423978
            torch.nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                        b=2 * std, generator=generator)
            m.bias.zero_()
    return model
