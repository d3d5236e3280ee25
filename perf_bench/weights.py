"""Weights from the seed, made on the device in a few large calls.

One ``torch.Generator`` on the device draws one flat normal buffer and one
flat uniform buffer for the whole network; each tensor of the state dict is
a scaled slice of them. Two inits, as the program's own tools use them:

  * ``fan_in``: conv and linear weights N(0, 2 / fan_in), biases N(0, 0.1),
    BatchNorm scale U(0.5, 1), shift N(0, 0.1), running mean N(0, 0.1),
    running variance U(0.5, 2) (``chip_smoke.fan_in_init``: activations stay
    O(1) through the full-width network, so serving finds peaks);
  * ``reference``: conv weights N(0, 0.001), linear weights N(0, 0.01), zero
    biases, BatchNorm at identity (models/posenet.py:124-144, the program's
    training init).

The names and shapes come from the plain reference model, whose state dict
the program's model shares.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

INITS = ("fan_in", "reference")


def spec(model: torch.nn.Module) -> Dict[str, Tuple[tuple, str]]:
    """{state-dict name: (shape, role)} of ``model`` (on any device, the
    ``meta`` one included), in state-dict order; the role says how a tensor
    is drawn: ``conv``/``linear`` weight, ``bias``, ``bn_weight``,
    ``bn_bias``, ``running_mean``, ``running_var`` or ``count``."""
    roles = {}
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, torch.nn.BatchNorm2d):
            roles.update({pre + "weight": "bn_weight", pre + "bias": "bn_bias",
                          pre + "running_mean": "running_mean",
                          pre + "running_var": "running_var",
                          pre + "num_batches_tracked": "count"})
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            kind = "conv" if isinstance(m, torch.nn.Conv2d) else "linear"
            roles.update({pre + "weight": kind, pre + "bias": "bias"})
    return {k: (tuple(v.shape), roles[k]) for k, v in model.state_dict().items()}


def make(shapes: Dict[str, Tuple[tuple, str]], seed: int, device, init: str
         ) -> Dict[str, torch.Tensor]:
    """A state dict on ``device`` for ``spec``'s (shape, role) pairs, drawn
    from ``seed``: fp32 tensors, and int64 zeros for BatchNorm's counts."""
    if init not in INITS:
        raise ValueError(f"unknown init {init!r}; have {INITS}")
    sizes = {k: int(torch.Size(s).numel()) for k, (s, _) in shapes.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    n = sum(sizes.values())
    normal = torch.randn(n, generator=gen, device=device)
    uniform = torch.rand(n, generator=gen, device=device)
    out, o = {}, 0
    for k, (shape, role) in shapes.items():
        m = sizes[k]
        z, u = normal[o:o + m].view(shape), uniform[o:o + m].view(shape)
        o += m
        if role == "count":
            out[k] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        if init == "reference":
            if role in ("conv", "linear"):
                t = z * (0.001 if role == "conv" else 0.01)
            elif role in ("bn_weight", "running_var"):
                t = torch.ones_like(z)
            else:
                t = torch.zeros_like(z)
        elif role in ("conv", "linear"):
            t = z * (2.0 / int(torch.Size(shape[1:]).numel())) ** 0.5
        elif role in ("bias", "bn_bias", "running_mean"):
            t = z * 0.1
        elif role == "bn_weight":
            t = u * 0.5 + 0.5
        else:
            t = u * 1.5 + 0.5
        out[k] = t
    return out
