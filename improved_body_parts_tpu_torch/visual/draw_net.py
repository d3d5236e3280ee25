"""The network's structure: its module table and its parameters and FLOPs.

    python -m improved_body_parts_tpu_torch.visual.draw_net [Canonical] \
        [--tiny] [--device cpu]

Port of the repo's ``visual/draw_net.py`` (the reference drew the autograd
graph with graphviz, visual/draw_net.py:1-30; the JAX script prints Flax's
``nn.tabulate`` at depth 2). One forward of a zero 1 x 128 x 128 frame with
forward hooks on every module down to depth 2 gives each row its output
shape; each row also has its parameter count. Then ``utils/profiling.
model_stats`` (parameters, and forward FLOPs at 128²). ``--tiny`` is the
JAX script's tiny model (nstack 2, inp_dim 32, increase 16). Weights are
the reference init from seed 0. Runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import torch

SIZE = 128


def _shape(out) -> str:
    if isinstance(out, torch.Tensor):
        return "x".join(map(str, out.shape))
    if isinstance(out, (list, tuple)):
        return "[" + ", ".join(_shape(o) for o in out) + "]"
    return type(out).__name__


def module_table(model: torch.nn.Module, depth: int = 2,
                 size: int = SIZE) -> List[Tuple[str, str, str, int]]:
    """(name, type, output shape, parameters) of every module down to
    ``depth``, from one forward of a zero (1, size, size, 3) frame."""
    device = next(model.parameters()).device
    mods = [(n, m) for n, m in model.named_modules()
            if n.count(".") < depth]
    shapes, hooks = {}, []

    def hook(name):
        def record(module, args, out):      # returns None: output unchanged
            shapes.setdefault(name, _shape(out))
        return record

    for name, mod in mods:
        hooks.append(mod.register_forward_hook(hook(name)))
    try:
        with torch.inference_mode():
            model(torch.zeros((1, size, size, 3), device=device))
    finally:
        for h in hooks:
            h.remove()
    return [(name or "(model)", type(mod).__name__, shapes.get(name, "-"),
             sum(p.numel() for p in mod.parameters()))
            for name, mod in mods]


def describe(model_cfg, device: torch.device, print_fn=print) -> dict:
    """Print the table and ``model_stats`` of the network of ``model_cfg``
    (bf16 convs); returns the ``model_stats`` dict."""
    from improved_body_parts_tpu_torch.models.imhn import create_model
    from improved_body_parts_tpu_torch.utils.profiling import model_stats

    g = torch.Generator().manual_seed(0)
    model = create_model(model_cfg, compute_dtype=torch.bfloat16,
                         generator=g).eval().to(device)
    rows = module_table(model)
    w = max(len(r[0]) for r in rows)
    print_fn(f"{'module':<{w}}  {'type':<20} {'output':<40} params")
    for name, kind, shape, n in rows:
        print_fn(f"{name:<{w}}  {kind:<20} {shape:<40} {n:,}")
    stats = model_stats(model, SIZE, SIZE, device=device)
    print_fn(f"total: {stats['params']:,} parameters, "
             f"{stats['flops'] / 1e9:.2f} GFLOPs a {SIZE}x{SIZE} frame")
    return stats


def main(argv=None) -> int:
    from improved_body_parts_tpu_torch.apps.demo_image import default_device
    from improved_body_parts_tpu_torch.configs import ModelConfig, get_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default="Canonical")
    ap.add_argument("--tiny", action="store_true",
                    help="nstack 2, inp_dim 32, increase 16")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    cfg = (ModelConfig(nstack=2, inp_dim=32, increase=16) if args.tiny
           else get_config(args.config).model)
    describe(cfg, default_device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
