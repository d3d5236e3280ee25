"""Post-training int8 quantization of the port's ``PoseNet``.

Port of ``improved_body_parts_tpu/models/quantize.py`` (:52-197), in its
order and arithmetic:
  1. ``fold_conv_bn``: every conv block's BatchNorm (running statistics)
     folded into its conv, in fp32: ``f = scale / sqrt(var + 1e-5)``,
     ``W * f``, ``bias - mean * f``.
  2. ``calibrate``: the folded model (``quant="calib"``) over a few
     batches; each conv block's input fp32 abs-max, the max over batches.
  3. ``build_quantized``: symmetric int8 weights with per-output-channel
     scales ``max(max|W| / 127, 1e-12)``, a per-tensor activation scale
     ``max(absmax / 127, 1e-8)``, rounding half to even, clipped to ±127.
  4. The ``quant="int8"`` model runs each conv through
     ``ops.kernels.int8_conv``; the SE linears stay in ``compute_dtype``.

``save_quantized`` writes the int8 model as a ``.pth`` in the port's own
layout (the JAX package writes orbax): about 4x smaller than the fp32
weights, and it loads with no calibration. Only the live ``PoseNet``
quantizes (``IndependentPoseNet`` refuses, as in JAX).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterable

import numpy as np
import torch
from torch import nn

from improved_body_parts_tpu_torch.configs import ModelConfig
from improved_body_parts_tpu_torch.models.imhn import BN_EPS, PoseNet, QConv2d

QUANT_TAG = "int8"


def _conv_bn_pairs(model: nn.Module) -> Dict[str, str]:
    """{conv name: BatchNorm name} for every ``nn.Conv2d`` that is followed
    directly by a ``BatchNorm2d`` among its parent's children (``Conv``:
    conv, bn; ``Backbone``: conv1, bn1; a Residual's ``Sequential``: i,
    i + 1)."""
    pairs = {}
    for name, module in model.named_modules():
        kids = list(module.named_children())
        for (a, ca), (b, cb) in zip(kids, kids[1:]):
            if isinstance(ca, nn.Conv2d) and isinstance(cb, nn.BatchNorm2d):
                prefix = f"{name}." if name else ""
                pairs[prefix + a] = prefix + b
    return pairs


@torch.no_grad()
def fold_conv_bn(model: PoseNet) -> Dict[str, torch.Tensor]:
    """The fp ``PoseNet``'s weights with every BatchNorm folded into its
    conv: the state_dict of ``PoseNet(cfg, quant="calib")`` (each conv a
    ``weight`` and a ``bias``, no BN), fp32, on the model's device."""
    sd = model.state_dict()
    pairs = _conv_bn_pairs(model)
    bn_names = set(pairs.values())
    out = {}
    for key, val in sd.items():
        mod = key.rpartition(".")[0]
        if mod in bn_names:
            continue
        out[key] = val.detach().clone()
    for conv, bn in pairs.items():
        f = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + BN_EPS)
        out[f"{conv}.weight"] = sd[f"{conv}.weight"] * f[:, None, None, None]
        out[f"{conv}.bias"] = sd[f"{bn}.bias"] - sd[f"{bn}.running_mean"] * f
    return out


@torch.no_grad()
def calibrate(calib_model: PoseNet, batches: Iterable) -> Dict[str, torch.Tensor]:
    """Run a ``quant="calib"`` model over ``batches`` ((B, H, W, 3) images
    in [0, 1], numpy or torch); returns {conv name: 0-d fp32 input abs-max,
    the max over batches}, on the model's device."""
    if calib_model.quant != "calib":
        raise ValueError("calibrate() needs a quant='calib' model")
    device = next(calib_model.parameters()).device
    stats: Dict[nn.Module, torch.Tensor] = {}
    n = 0
    for imgs in batches:
        calib_model(torch.as_tensor(imgs).to(device, torch.float32), bn_stats=stats)
        n += 1
    if n == 0:
        raise ValueError("calibrate() needs at least one batch")
    names = {m: name for name, m in calib_model.named_modules()}
    return {names[m]: v for m, v in stats.items()}


@torch.no_grad()
def build_quantized(folded: Dict[str, torch.Tensor],
                    calib_stats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Folded weights (``fold_conv_bn``) and their calibration abs-max ->
    the state_dict of ``PoseNet(cfg, quant="int8")``: every 4-D conv
    weight becomes ``weight_q`` (Cout, kh*kw*Cin) int8 in (ky, kx, ci)
    order, ``bias``, ``w_scale`` and ``a_scale``; other tensors pass."""
    out = {}
    for key, val in folded.items():
        mod, _, leaf = key.rpartition(".")
        if leaf == "weight" and val.dim() == 4:
            w = val.float()
            a_scale = np.float32(max(float(calib_stats[mod]) / 127.0, 1e-8))
            w_scale = (w.abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-12)
            kq = torch.clamp(torch.round(w / w_scale[:, None, None, None]), -127, 127)
            out[f"{mod}.weight_q"] = (kq.to(torch.int8).permute(0, 2, 3, 1)
                                      .reshape(w.shape[0], -1).contiguous())
            out[f"{mod}.bias"] = folded[f"{mod}.bias"].float()
            out[f"{mod}.w_scale"] = w_scale
            out[f"{mod}.a_scale"] = torch.tensor(a_scale, device=w.device)
        elif not (leaf == "bias" and f"{mod}.weight" in folded
                  and folded[f"{mod}.weight"].dim() == 4):
            out[key] = val
    return out


def make_quant_model(cfg: ModelConfig, quant: str, device, compute_dtype) -> PoseNet:
    """An empty ``PoseNet(cfg, quant=quant)`` on ``device`` (channels_last
    on the card), for ``load_state_dict``."""
    model = PoseNet(cfg, quant=quant, device="meta", compute_dtype=compute_dtype)
    model = model.to_empty(device=device)
    if torch.device(device).type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return model


def quantize_model(model: PoseNet, calib_batches: Iterable) -> PoseNet:
    """One-call PTQ: the fp ``PoseNet`` and calibration images -> the int8
    ``PoseNet`` on the same device, with the same ``compute_dtype``."""
    if not isinstance(model, PoseNet) or model.quant is not None:
        raise ValueError("quantization supports the live PoseNet only, "
                         "from fp weights")
    device = next(model.parameters()).device
    folded = fold_conv_bn(model)
    calib = make_quant_model(model.cfg, "calib", device, model.compute_dtype)
    calib.load_state_dict(folded, strict=True)
    stats = calibrate(calib, calib_batches)
    qmodel = make_quant_model(model.cfg, "int8", device, model.compute_dtype)
    qmodel.load_state_dict(build_quantized(folded, stats), strict=True)
    return qmodel


def count_int8_convs(model: nn.Module) -> int:
    """The int8 conv blocks of a model (each a ``QConv2d``)."""
    return sum(isinstance(m, QConv2d) for m in model.modules())


# ---------------------------------------------------------------------------
# quantized serving checkpoints: ~4x smaller than the fp32 weights, and
# loaded without calibration data
# ---------------------------------------------------------------------------

def save_quantized(path: str, qmodel: PoseNet) -> None:
    """Write an int8 ``PoseNet`` as ``{"quantized": "int8", "weights":
    state_dict}`` (written through a temporary name)."""
    if qmodel.quant != QUANT_TAG:
        raise ValueError("save_quantized() needs a quant='int8' model")
    sd = {k: v.detach().cpu() for k, v in qmodel.state_dict().items()}
    torch.save({"quantized": QUANT_TAG, "weights": sd}, path + ".tmp")
    os.replace(path + ".tmp", path)


def _read(path: str):
    if not os.path.isfile(path):
        return None
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError, ValueError):
        return None         # not a file of save_quantized (or not a .pth)
    if isinstance(ckpt, dict) and ckpt.get("quantized") == QUANT_TAG:
        return ckpt
    return None


def is_quantized_checkpoint(path: str) -> bool:
    """True if ``path`` is a file written by ``save_quantized``."""
    return _read(path) is not None


def load_quantized(cfg: ModelConfig, path: str, *, device,
                   compute_dtype: torch.dtype = torch.bfloat16) -> PoseNet:
    """A ``save_quantized`` file -> the int8 ``PoseNet`` on ``device``."""
    ckpt = _read(path)
    if ckpt is None:
        raise ValueError(f"{path} is not an int8 checkpoint of save_quantized")
    model = make_quant_model(cfg, QUANT_TAG, device, compute_dtype)
    model.load_state_dict(ckpt["weights"], strict=True)
    return model
