"""Training library: the train step as plain functions on tensors.

The port of ``improved_body_parts_tpu/train_lib.py`` (:36-174, 325-352),
which re-designed the reference trainers (train.py, train_distributed.py,
train_distributed_SWA.py) as one functional step:

  * SGD(momentum=0.9, weight_decay=1e-4) exactly as torch SGD and the JAX
    package's optax chain apply it — decay added to the gradient of EVERY
    parameter (BN scale/shift and biases included) before the momentum
    trace, ``p <- p - lr * (g + wd * p + momentum * m)``
    (train_distributed.py:122-123);
  * epoch-step LR schedule with 3-epoch linear warmup, and the SWA cyclic
    LR (train_distributed.py:396-423), on the host;
  * abnormal-loss batch dropping (train_distributed.py:273-275): the new
    parameters, momentum buffers and BN running statistics are selected
    against the old ones ON THE DEVICE from ``ok = isfinite(loss) &
    (loss <= thresh)``, with no host sync in the step;
  * optional global-norm gradient clipping, the norm taken before the decay;
  * SWA: a running parameter average (train_distributed_SWA.py:403-424).

The state is updated in place (the JAX step returns a new state); metrics
(``loss``, ``grad_norm``, ``skipped``) stay on the device until the caller
fetches them. The step reads no value from the host and copies nothing
from it (the learning rate is a 0-d tensor on the device, the loss's and
the GT renderer's constants are made once), so it can be captured in a
CUDA graph (``train_graph.py``).

Also ported (:177-322): the step of the device-resident feed
(``make_resident_train_step``, ``data/resident.py``), whose preprocessing
``resident_inputs`` gathers, warps and decimates on the device, and the
K-steps-per-dispatch functions (``make_multi_train_step``,
``make_multi_resident_train_step``), a CUDA graph of the captured step on
the card.

Data parallel (``mesh=``, a ``parallel/mesh.Mesh`` with a process group;
one process a card): each rank takes its slice of the global batch; the
train-mode BatchNorm statistics are the global batch's
(``parallel/mesh.BatchStats``, with the gradient flowing back through the
reduction); the gradients and the loss are averaged over the ranks by one
all-reduce of a flat buffer, before the global norm, the clip and the
abnormal-loss rule, so every rank takes the same decision and the same
update. The result is the step of the JAX package on the global batch,
whose loss divides by the batch. The model is not wrapped in
``DistributedDataParallel``: the step takes its gradients with
``torch.autograd.grad``, where DDP's reducer hooks would never fire.
A resident store sharded over the ranks (``--resident-shard-store``)
needs nothing more: each rank's plan indexes its own record range
(``ResidentFeed.plan_batches(store_shards=world)``), with no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from improved_body_parts_tpu_torch.configs import CanonicalConfig, TrainConfig
from improved_body_parts_tpu_torch.data.resident import BORDER_BGR
from improved_body_parts_tpu_torch.losses import multi_task_loss
from improved_body_parts_tpu_torch.ops.warp import affine_warp
from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
from improved_body_parts_tpu_torch.train_graph import MultiStep

BN_MOMENTUM = 0.9        # Flax decay 0.9 == torch momentum 0.1


@dataclasses.dataclass
class TrainState:
    """What the JAX ``TrainState`` holds, around a live model: parameters
    and BN statistics live in ``model``; ``momentum`` is the optax trace
    (torch SGD's momentum buffer), keyed by parameter name."""
    model: torch.nn.Module
    momentum: Dict[str, torch.Tensor]
    step: torch.Tensor                          # int64 global step, on the device
    swa_params: Optional[Dict[str, torch.Tensor]]
    swa_count: torch.Tensor                     # int64 SWA accumulations


def create_train_state(model: torch.nn.Module, cfg: TrainConfig) -> TrainState:
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return TrainState(
        model=model,
        momentum={k: torch.zeros_like(p) for k, p in params.items()},
        step=torch.zeros((), dtype=torch.int64, device=dev),
        swa_params=({k: torch.zeros_like(p) for k, p in params.items()}
                    if cfg.swa else None),
        swa_count=torch.zeros((), dtype=torch.int64, device=dev),
    )


def learning_rate(cfg: TrainConfig, epoch: int, step_in_epoch: int,
                  len_epoch: int, data_parallel: int = 1,
                  use_warmup: bool = True) -> float:
    """Host-side LR schedule. reference: train_distributed.py:396-414."""
    factor = epoch // cfg.lr_step_epochs
    if epoch >= cfg.lr_late_epoch:
        factor = (epoch - cfg.lr_late_epoch) // cfg.lr_late_step_epochs
    lr = cfg.learning_rate * data_parallel * (cfg.lr_step_factor ** factor)
    if use_warmup and epoch < cfg.warmup_epochs:
        lr = lr * float(1 + step_in_epoch + epoch * len_epoch) / (
            cfg.warmup_epochs * len_epoch)
    return lr


def cyclic_learning_rate(cfg: TrainConfig, epoch: int, start_epoch: int) -> float:
    """SWA cyclic LR. reference: train_distributed.py:417-423."""
    e = epoch - start_epoch
    f = cfg.swa_freq_epochs
    if f <= 1:
        return cfg.swa_lr_min
    return cfg.swa_lr_max - (cfg.swa_lr_max - cfg.swa_lr_min) / (f - 1) * (e - e // f * f)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def _lr_tensor(lr, ref: torch.Tensor) -> torch.Tensor:
    """``lr`` (a float, or a 0-d tensor) as a 0-d tensor on ``ref``'s
    device in ``ref``'s float type (at least fp32). A float is written by a
    fill on the device, not copied from the host."""
    dt = torch.promote_types(ref.dtype, torch.float32)
    if isinstance(lr, torch.Tensor):
        return lr.to(ref.device, dt)
    return torch.full((), lr, dtype=dt, device=ref.device)


def _select_(ok: torch.Tensor, new: List[torch.Tensor],
             old: List[torch.Tensor]) -> None:
    """old <- where(ok, new, old), in place, on the device."""
    for n, o in zip(new, old):
        torch.where(ok, n, o, out=o)


def _data_parallel(mesh) -> bool:
    return mesh is not None and mesh.data_parallel


def make_train_step(model: torch.nn.Module, cfg: CanonicalConfig,
                    use_focal: bool = True, freeze_bn: bool = False,
                    compact_gt: bool = False, mesh=None):
    """Build the train step ``(state, imgs, mask, heat, lr) -> metrics``.

    imgs: (B, H, W, 3) float in [0, 1], or uint8 (normalized in the step as
    ``float32 / 255``); mask: (B, H/4, W/4, 1); heat: (B, H/4, W/4, 50) —
    or, with ``compact_gt``, the pair (joints (B,P,18,3), mask_all (B,h,w))
    rasterized on the device (data/heatmaps_device.py). ``lr`` is a 0-d
    tensor (or a float); the update is ``p + (-lr * u)``, as optax applies
    it, from the same kernels whether the step runs eagerly or replays in a
    CUDA graph.
    ``freeze_bn`` runs BatchNorm in inference mode and keeps the running
    statistics fixed (the reference's SWA epochs, train_distributed_SWA.py:221).
    ``state`` is updated in place; the returned metrics are 0-d tensors on
    the device: ``loss``, ``grad_norm`` and ``skipped`` (1.0 when the
    abnormal-loss rule kept the old state). With a data-parallel ``mesh``
    the inputs are this rank's slice, and the metrics are the global
    batch's, the same on every rank.
    """
    tcfg = cfg.train
    renderer = None
    if compact_gt:
        from improved_body_parts_tpu_torch.data.heatmaps_device import DeviceHeatmapper
        renderer = DeviceHeatmapper(cfg)
    names = [k for k, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    group = mesh.group if _data_parallel(mesh) else None

    def step_fn(state: TrainState, imgs, mask, heat, lr):
        if state.model is not model:
            raise ValueError("the state belongs to another model")
        if imgs.dtype == torch.uint8:
            # uint8 wire format (--feed compact-u8): f32 intermediate so the
            # only deviation from the fp32 feed is the <=1/510 quantization
            imgs = imgs.float() / 255.0
        if compact_gt:
            heat = renderer.render(*heat)
        # a dict: train-mode BN (over the global batch with a group)
        bn_stats = (None if freeze_bn else
                    {} if group is None else mesh_lib.BatchStats(group))
        outs = model(imgs, bn_stats=bn_stats)
        loss = multi_task_loss(outs, heat, mask, tcfg, use_focal=use_focal)
        grads = list(torch.autograd.grad(loss, params))

        with torch.no_grad():
            if group is not None:
                # the global batch's gradient and loss: every rank's mean
                # over its slice, averaged over the ranks in one all-reduce
                *grads, loss = mesh_lib.all_reduce_mean(
                    [*grads, loss.detach()], group)
                # the loss alone: a view would keep the flat buffer (every
                # gradient) alive for as long as the caller keeps the metric
                loss = loss.clone()
            gnorm = global_norm(grads)
            if tcfg.max_grad_norm > 0:
                scale = torch.clamp(tcfg.max_grad_norm / (gnorm + 1e-6), max=1.0)
                torch._foreach_mul_(grads, scale)
            moms = [state.momentum[k] for k in names]
            # optax add_decayed_weights then trace: u = g + wd*p; m' = u + 0.9*m
            upd = torch._foreach_add(grads, params, alpha=tcfg.weight_decay)
            torch._foreach_add_(upd, moms, alpha=tcfg.momentum)
            neg_lr = -_lr_tensor(lr, params[0])
            new_params = torch._foreach_add(params, torch._foreach_mul(upd, neg_lr))

            # abnormal-loss batch drop: keep everything unchanged on explosion
            ok = torch.isfinite(loss) & (loss <= tcfg.abnormal_loss_thresh)
            _select_(ok, new_params, params)
            _select_(ok, upd, moms)
            for bn, (mean, var) in (bn_stats or {}).items():
                new_mean = BN_MOMENTUM * bn.running_mean + (1 - BN_MOMENTUM) * mean
                new_var = BN_MOMENTUM * bn.running_var + (1 - BN_MOMENTUM) * var
                _select_(ok, [new_mean, new_var], [bn.running_mean, bn.running_var])
            state.step += 1
        return {"loss": loss.detach(), "grad_norm": gnorm,
                "skipped": (~ok).float()}

    return step_fn


def resident_inputs(store: Dict[str, torch.Tensor], idx: torch.Tensor,
                    inv_m: torch.Tensor, cfg: CanonicalConfig,
                    dtype: torch.dtype = torch.float32) -> tuple:
    """The resident feed's preprocessing, on the store's device
    (JAX ``train_lib._build_resident_fn``): gather the records ``idx`` (B,)
    from the uint8 ``store`` (``data/resident.ResidentStore.device_arrays``;
    never written), normalize (/ 255), warp each sample by its inverse map
    ``inv_m`` (B, 2, 3) onto the (H, W) canvas of ``cfg``, filled with the
    reference's border colours (py_data_transformer.py:118-129):
    (124, 127, 127) / 255 for the image, 1 for ``mask_miss``, 0 for
    ``mask_all``; then decimate the masks to stride resolution by an exact
    box mean (cv2 INTER_AREA at an integer factor). A mask the store lacks
    is ones. Returns (images (B, H, W, 3), mask_miss (B, h, w, 1),
    mask_all (B, h, w)) in ``dtype``: fp32 as the JAX package computes
    them, or float64 for a float64 reference model."""
    H, W, s = cfg.height, cfg.width, cfg.stride
    h4, w4 = H // s, W // s
    B = idx.shape[0]
    inv_m = inv_m.to(dtype)

    def gather(key):
        return store[key].index_select(0, idx).to(dtype) / 255.0

    def mask(key, fill):
        if key not in store:
            return torch.ones((B, h4, w4), dtype=dtype, device=idx.device)
        m = affine_warp(gather(key)[..., None], inv_m, fill_value=fill,
                        out_hw=(H, W))[..., 0]
        return m.reshape(B, h4, s, w4, s).mean(dim=(2, 4))

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    border = np.asarray(BORDER_BGR, np_dtype) / np_dtype(255)
    imgs = affine_warp(gather("images"), inv_m, fill_value=border,
                       out_hw=(H, W))
    return imgs, mask("mask_miss", 1.0)[..., None], mask("mask_all", 0.0)


def make_resident_train_step(model: torch.nn.Module, cfg: CanonicalConfig,
                             use_focal: bool = True, freeze_bn: bool = False,
                             mesh=None):
    """The train step of the device-resident feed (``data/resident.py``):
    ``(state, store, idx, inv_m, joints, lr) -> metrics``, where ``store``
    is the dict of uint8 arrays on the device, ``idx`` (B,) the records,
    ``inv_m`` (B, 2, 3) the inverse augmentation maps (identity when
    unaugmented) and ``joints`` (B, P, 18, 3) the joints warped on the host.
    ``resident_inputs`` (fp32; float64 for a float64 model), then the
    compact-GT step of ``make_train_step``. With a data-parallel ``mesh``,
    ``store`` may hold only this rank's record range and ``idx`` index it
    (a sharded store): the gather is local.
    reference: JAX ``train_lib.make_resident_train_step``."""
    step = make_train_step(model, cfg, use_focal=use_focal,
                           freeze_bn=freeze_bn, compact_gt=True, mesh=mesh)
    dtype = torch.promote_types(next(model.parameters()).dtype, torch.float32)

    def resident_fn(state: TrainState, store, idx, inv_m, joints, lr):
        imgs, mask_miss, mask_all = resident_inputs(store, idx, inv_m, cfg, dtype)
        return step(state, imgs, mask_miss, (joints, mask_all), lr)

    return resident_fn


def make_multi_train_step(model: torch.nn.Module, cfg: CanonicalConfig,
                          use_focal: bool = True, freeze_bn: bool = False,
                          compact_gt: bool = False, pool=None,
                          mesh=None) -> MultiStep:
    """n train steps a call: ``(state, imgs, mask, heat, lr) -> metrics``,
    where every input carries a leading step axis of length n (imgs (n, B,
    H, W, 3), ``lr`` (n,)) and the metrics come back stacked (n,). On the
    card the step is captured once in a CUDA graph and replayed n times;
    ``pool`` (``torch.cuda.graph_pool_handle()``) is the memory pool the
    graph shares, e.g. with the SWA epochs' graph. On the CPU, n eager
    steps. With a data-parallel ``mesh`` the collectives are inside the
    graph (NCCL); a gloo group cannot be captured, so its n steps run
    eagerly (``MultiStep.eager_reason``). reference: JAX
    ``train_lib.make_multi_train_step`` (one ``lax.scan`` of the n steps)."""
    return MultiStep(make_train_step(model, cfg, use_focal=use_focal,
                                     freeze_bn=freeze_bn, compact_gt=compact_gt,
                                     mesh=mesh),
                     n_fixed=0, pool=pool, mesh=mesh)


def make_multi_resident_train_step(model: torch.nn.Module, cfg: CanonicalConfig,
                                   use_focal: bool = True, freeze_bn: bool = False,
                                   pool=None, mesh=None) -> MultiStep:
    """n resident train steps a call: ``(state, store, idx (n, B), inv_m
    (n, B, 2, 3), joints (n, B, P, 18, 3), lr (n,)) -> metrics`` stacked
    (n,), each step gathering from the same store; on the card a CUDA graph
    as ``make_multi_train_step``. reference: JAX
    ``train_lib.make_multi_resident_train_step``."""
    return MultiStep(make_resident_train_step(model, cfg, use_focal=use_focal,
                                              freeze_bn=freeze_bn, mesh=mesh),
                     n_fixed=1, pool=pool, mesh=mesh)


def make_eval_step(model: torch.nn.Module, cfg: CanonicalConfig,
                   use_focal: bool = True):
    """Validation loss ``(imgs, mask, heat) -> loss`` with running BN
    statistics (reference test(), train_distributed.py:341-393)."""
    tcfg = cfg.train

    @torch.no_grad()
    def eval_fn(imgs, mask, heat):
        if imgs.dtype == torch.uint8:
            imgs = imgs.float() / 255.0
        return multi_task_loss(model(imgs, train=False), heat, mask, tcfg,
                               use_focal=use_focal)

    return eval_fn


@torch.no_grad()
def swa_update(state: TrainState) -> None:
    """Accumulate the running parameter average, (avg * n + p) / (n + 1).

    reference: torchcontrib SWA optimizer.update_swa()
    (train_distributed_SWA.py:403-424)."""
    n = state.swa_count.float()
    for k, p in state.model.named_parameters():
        avg = state.swa_params[k]
        avg.copy_((avg * n + p) / (n + 1.0))
    state.swa_count += 1


@torch.no_grad()
def swa_swap(state: TrainState) -> None:
    """Swap current params with the SWA average (swap_swa_sgd equivalent)."""
    for k, p in state.model.named_parameters():
        tmp = p.detach().clone()
        p.copy_(state.swa_params[k])
        state.swa_params[k].copy_(tmp)


# ---------------------------------------------------------------------------
# the state as a checkpoint payload (utils/checkpoint.save_train_state)
# ---------------------------------------------------------------------------

def state_payload(state: TrainState, cfg: TrainConfig, **extra) -> dict:
    """The state in the reference's checkpoint layout, on the CPU:
    ``weights`` (reference-keyed state_dict), ``optimizer_weight`` (the SGD
    momentum buffers by parameter name, with the SGD settings), ``step``,
    ``swa_params``/``swa_count``, plus ``extra`` (``epoch``,
    ``train_loss``)."""
    cpu = lambda d: {k: v.detach().cpu().clone() for k, v in d.items()}
    payload = {
        "weights": cpu(state.model.state_dict()),
        "optimizer_weight": {
            "momentum_buffer": cpu(state.momentum),
            "momentum": cfg.momentum, "dampening": 0.0,
            "weight_decay": cfg.weight_decay, "nesterov": False},
        "step": int(state.step),
        "swa_params": None if state.swa_params is None else cpu(state.swa_params),
        "swa_count": int(state.swa_count),
    }
    payload.update(extra)
    return payload


@torch.no_grad()
def load_payload(state: TrainState, payload: dict) -> None:
    """Copy a ``state_payload`` (or ``utils/checkpoint.train_state_from_flax``
    output) into ``state``, in place. A payload without ``swa_params`` leaves
    the state's SWA average as it is (resuming --swa from a run without)."""
    state.model.load_state_dict(payload["weights"], strict=True)
    moms = payload["optimizer_weight"]["momentum_buffer"]
    if set(moms) != set(state.momentum):
        raise KeyError("momentum buffers do not match the model's parameters: "
                       f"{sorted(set(moms) ^ set(state.momentum))[:4]}")
    for k, m in moms.items():
        state.momentum[k].copy_(m)
    state.step.fill_(int(payload["step"]))
    if payload.get("swa_params") is not None and state.swa_params is not None:
        for k, a in payload["swa_params"].items():
            state.swa_params[k].copy_(a)
        state.swa_count.fill_(int(payload["swa_count"]))
