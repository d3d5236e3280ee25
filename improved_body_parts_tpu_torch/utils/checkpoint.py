"""Weights into the port's ``PoseNet``, without jax.

  * ``state_dict_from_flax`` turns the JAX package's variables (nested dicts
    of numpy arrays: ``params`` and ``batch_stats``) into a state_dict with
    the reference's key names. It inverts the key mapping of
    ``improved_body_parts_tpu/utils/checkpoint.map_reference_key``
    (:87-172): conv HWIO -> OIHW, Dense (I, O) -> Linear (O, I), BatchNorm
    ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
    ``running_mean``/``running_var``. The reference has no names for the
    ``extra_attention`` SE layers (Flax ``chattn<t>_s<s>``, here
    ``chattn.<t>.<s>``) nor for ``IndependentPoseNet`` and ``AEPoseNet``,
    whose port modules carry the Flax names: ``flax_to_variant_key`` joins
    the Flax path with dots, writing a Residual's ``conv1``/``conv2``/
    ``conv3``/``skip`` as the reference's ``convBlock.<i>``/``skipConv.<i>``.
    A tree with a top-level ``pre0`` (those two families) takes that
    mapping.
  * ``qstate_from_flax`` turns the JAX package's int8 param tree
    (``models/quantize.build_quantized``) into the state_dict of the port's
    ``PoseNet(quant="int8")``: ``kernel_q`` HWIO -> ``weight_q`` (O,
    kh*kw*I) in the kernel's (ky, kx, ci) order.
  * ``train_state_from_flax`` carries a whole JAX ``TrainState`` across:
    the above, plus the optax momentum trace and the SWA average under the
    same keys, as a ``train_lib.load_payload`` payload.
  * ``load_reference_pth`` reads a released reference ``.pth``, and a
    checkpoint the port's trainer wrote.
  * ``save_train_state`` / ``restore_train_state`` write and read the
    trainer's checkpoints: one ``epoch_<N>.pth`` a save in the reference's
    dict layout ``{weights, optimizer_weight, train_loss, epoch}`` (its
    train_distributed.py:326-338) plus ``step``, ``swa_params`` and
    ``swa_count``; they replace the JAX package's orbax calls.

The JAX converter cannot be shared because its module imports jax.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# Residual sub-module -> index inside the reference's convBlock/skipConv
_RES_CONV = {"conv1": 0, "conv2": 3, "conv3": 6}
_HG_SLOT = {"up1": 0, "low1": 1, "low2": 2, "refine": 3, "inner": 4}
_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
_SE_FC = {"fc1": "fc.0", "fc2": "fc.2"}


def _residual_key(sub: str, kind: str) -> str:
    """('conv2', 'bn') -> 'convBlock.4'; ('skip', 'conv') -> 'skipConv.0'."""
    if sub == "skip":
        return "skipConv." + ("0" if kind == "conv" else "1")
    return f"convBlock.{_RES_CONV[sub] + (kind == 'bn')}"


def flax_to_reference_key(path: Tuple[str, ...], leaf: str) -> str:
    """Reference state_dict key for one Flax leaf (``path`` of module names,
    ``leaf`` in kernel/bias/scale/mean/var). Raises KeyError if unmapped."""
    torch_leaf = "weight" if leaf == "kernel" else _BN_LEAF[leaf]
    top, rest = path[0], path[1:]
    if top == "pre":
        name = rest[0]
        if name == "conv1":
            mod = "pre.conv1" if rest[1] == "conv" else "pre.bn1"
        elif name in ("res1", "res2"):
            mod = f"pre.{name}." + _residual_key(rest[1], rest[2])
        else:
            i = re.fullmatch(r"dilated(\d)", name).group(1)
            mod = f"pre.dilation.{i}.{rest[1]}"
        return f"{mod}.{torch_leaf}"
    m = re.fullmatch(r"hg(\d+)", top)
    if m:
        d, slot = re.fullmatch(r"d(\d)_(\w+)", rest[0]).groups()
        base = f"hourglass.{m.group(1)}.hg.{d}.{_HG_SLOT[slot]}"
        if slot == "refine":
            return f"{base}.{rest[1]}.{torch_leaf}"
        return f"{base}.{_residual_key(rest[1], rest[2])}.{torch_leaf}"
    m = re.fullmatch(r"features(\d+)", top)
    if m:
        s, part = re.fullmatch(r"s(\d)_(\w+)", rest[0]).groups()
        base = f"features.{m.group(1)}.before_regress.{s}"
        if part == "se":
            fc = "0" if rest[1] == "fc1" else "2"
            return f"{base}.2.fc.{fc}.{torch_leaf}"
        i = int(part[len("conv"):]) - 1
        return f"{base}.{i}.{rest[1]}.{torch_leaf}"
    m = re.fullmatch(r"out(\d+)_s(\d)", top)
    if m:
        return f"outs.{m.group(1)}.{m.group(2)}.conv.{torch_leaf}"
    m = re.fullmatch(r"chattn(\d+)_s(\d)", top)
    if m:
        return f"chattn.{m.group(1)}.{m.group(2)}.{_SE_FC[rest[0]]}.{torch_leaf}"
    m = re.fullmatch(r"merge_(pred|feat)(\d+)_s(\d)", top)
    if m:
        kind = "merge_preds" if m.group(1) == "pred" else "merge_features"
        return f"{kind}.{m.group(2)}.{m.group(3)}.conv.{rest[0]}.{torch_leaf}"
    raise KeyError(f"no reference key for flax leaf {path}/{leaf}")


def flax_to_variant_key(path: Tuple[str, ...], leaf: str) -> str:
    """Port key of one Flax leaf of ``IndependentPoseNet`` or ``AEPoseNet``
    (module docstring)."""
    torch_leaf = "weight" if leaf == "kernel" else _BN_LEAF[leaf]
    out, i = [], 0
    while i < len(path):
        name = path[i]
        if (name in _RES_CONV or name == "skip") and i + 1 < len(path):
            out.append(_residual_key(name, path[i + 1]))
            i += 1
        else:
            out.append(name)
        i += 1
    return ".".join(out + [torch_leaf])


def _key_fn(tree: Dict[str, Any]):
    return flax_to_variant_key if "pre0" in tree else flax_to_reference_key


def _leaves(tree: Dict[str, Any], path=()) -> Iterator[Tuple[Tuple[str, ...], str, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path, k, v


def _reference_tensors(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Flax tree shaped like ``params`` or ``batch_stats`` -> fp32 tensors
    (float64 stays float64) under reference keys, laid out as the port's
    parameters."""
    out: Dict[str, torch.Tensor] = {}
    key = _key_fn(tree)
    for path, leaf, val in _leaves(tree):
        arr = np.asarray(val)
        arr = arr.astype(np.float64 if arr.dtype == np.float64 else np.float32)
        if leaf == "kernel":
            if arr.ndim == 4:          # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:        # Dense (I, O) -> Linear (O, I)
                arr = arr.T
        out[key(path, leaf)] = torch.from_numpy(np.array(arr))
    return out


def state_dict_from_flax(params: Dict[str, Any],
                         batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``(params, batch_stats)`` -> reference-keyed fp32 state_dict
    (every BatchNorm also gets ``num_batches_tracked`` = 0, so the result
    loads into ``PoseNet`` with ``strict=True``)."""
    out = _reference_tensors(params)
    for key, val in _reference_tensors(batch_stats).items():
        out[key] = val
        if key.endswith("running_mean"):
            out[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def qstate_from_flax(qparams: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's int8 ``PoseNet`` params (each quantized ConvBlock a
    dict of ``kernel_q`` HWIO int8, ``bias``, ``w_scale``, ``a_scale``; the
    SE Dense layers in fp32) -> the state_dict of the port's
    ``PoseNet(quant="int8")``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        if "kernel_q" in tree:
            name = flax_to_reference_key(path + ("conv",), "kernel")[:-len(".weight")]
            kq = np.asarray(tree["kernel_q"])
            if kq.dtype != np.int8:
                raise ValueError(f"{'/'.join(path)}: kernel_q is {kq.dtype}")
            kh, kw, cin, cout = kq.shape
            out[f"{name}.weight_q"] = torch.from_numpy(np.ascontiguousarray(
                kq.transpose(3, 0, 1, 2).reshape(cout, kh * kw * cin)))
            for leaf in ("bias", "w_scale", "a_scale"):
                out[f"{name}.{leaf}"] = torch.from_numpy(
                    np.array(tree[leaf], dtype=np.float32))
            return
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                arr = np.asarray(v, np.float32)
                out[flax_to_reference_key(path, k)] = torch.from_numpy(
                    np.array(arr.T if arr.ndim == 2 else arr))

    walk(qparams, ())
    return out


def train_state_from_flax(state) -> Dict[str, Any]:
    """A JAX ``train_lib.TrainState`` (any object with its fields; arrays
    are read with numpy) -> the payload ``train_lib.load_payload`` takes:
    ``weights`` (``state_dict_from_flax``), the optax ``trace`` as
    ``optimizer_weight["momentum_buffer"]``, ``step``, and ``swa_params`` /
    ``swa_count``, all under reference keys."""
    trace = next(s.trace for s in state.opt_state if hasattr(s, "trace"))
    return {
        "weights": state_dict_from_flax(state.params, state.batch_stats),
        "optimizer_weight": {"momentum_buffer": _reference_tensors(trace)},
        "step": int(np.asarray(state.step)),
        "swa_params": (None if state.swa_params is None
                       else _reference_tensors(state.swa_params)),
        "swa_count": int(np.asarray(state.swa_count)),
    }


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` ({'weights': state_dict, ...} or a bare
    state_dict) -> state_dict for ``PoseNet``: the ``module.``/``posenet.``
    prefixes of wrapped models are stripped and ``criterion.`` buffers
    dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("weights", ckpt)
    out = {}
    for key, val in sd.items():
        for pre in ("module.", "posenet."):
            if key.startswith(pre):
                key = key[len(pre):]
        if not key.startswith("criterion."):
            out[key] = val
    return out


# ---------------------------------------------------------------------------
# the trainer's checkpoints
# ---------------------------------------------------------------------------

_CKPT = re.compile(r"epoch_(\d+)\.pth$")


def checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{step}.pth")


def saved_steps(ckpt_dir: str) -> list:
    """The steps saved in ``ckpt_dir``, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(ckpt_dir))
                  if m)


def save_train_state(ckpt_dir: str, payload: Dict[str, Any], step: int,
                     keep: int = 3) -> str:
    """Write ``payload`` (``train_lib.state_payload``) as
    ``<ckpt_dir>/epoch_<step>.pth`` and delete all but the newest ``keep``
    files. The write goes through a temporary name, so a cut run leaves no
    half-written checkpoint. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_path(ckpt_dir, step)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in saved_steps(ckpt_dir)[:-keep] if keep > 0 else []:
        os.remove(checkpoint_path(ckpt_dir, old))
    return path


def restore_train_state(ckpt_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """Read a checkpoint of ``save_train_state``: ``step``, or the newest.
    ``DIR@N`` selects step N inside DIR, as the JAX package's does."""
    if step is None and "@" in os.path.basename(ckpt_dir):
        ckpt_dir, _, s = ckpt_dir.rpartition("@")
        step = int(s)
    if step is None:
        steps = saved_steps(ckpt_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
        step = steps[-1]
    return torch.load(checkpoint_path(ckpt_dir, step), map_location="cpu",
                      weights_only=True)
