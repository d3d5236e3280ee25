"""The benchmark's frozen copy of the port's configuration layer
(``configs.py``): its skeleton tables and its dataclasses with their
defaults. A configuration's values are not here but in its file under
``configs/`` (``from_file``). The layer unifies the reference's three config
sources into one module:
  * training/model hyper-parameters   (reference: config/config.py:8-22  ``TrainingOpt``)
  * augmentation parameters           (reference: config/config.py:25-49 ``TransformationParams``)
  * canonical skeleton topology       (reference: config/config.py:51-162 ``CanonicalConfig``)
  * COCO->canonical joint conversion  (reference: config/config.py:165-251 ``COCOSourceConfig``)
  * inference/post-processing INI     (reference: utils/config + utils/config_reader.py:6-37)

All tables are plain numpy so they can feed jitted kernels (as static constants) and
host code from one source of truth (the reference duplicated thresholds between the
INI file and the C++ header utils/pafprocess/pafprocess.h:6-17).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Canonical skeleton (CMU 18-part order + 2 background channels)
# reference: config/config.py:60-123
# ---------------------------------------------------------------------------

PARTS = (
    "nose", "neck", "Rsho", "Relb", "Rwri",
    "Lsho", "Lelb", "Lwri", "Rhip", "Rkne", "Rank",
    "Lhip", "Lkne", "Lank", "Reye", "Leye", "Rear", "Lear",
)
NUM_PARTS = len(PARTS)  # 18
PARTS_DICT: Dict[str, int] = {p: i for i, p in enumerate(PARTS)}

_LIMB_FROM_NAMES = (
    "neck", "neck", "neck", "neck", "neck", "nose", "nose", "Reye", "Leye",
    "neck", "Rsho", "Relb", "neck", "Lsho", "Lelb", "neck", "Rhip", "Rkne",
    "neck", "Lhip", "Lkne", "nose", "nose", "Rsho", "Rhip", "Lsho", "Lhip",
    "Rear", "Lear", "Rhip",
)
_LIMB_TO_NAMES = (
    "nose", "Reye", "Leye", "Rear", "Lear", "Reye", "Leye", "Rear", "Lear",
    "Rsho", "Relb", "Rwri", "Lsho", "Lelb", "Lwri", "Rhip", "Rkne", "Rank",
    "Lhip", "Lkne", "Lank", "Rsho", "Lsho", "Rhip", "Lkne", "Lhip", "Rkne",
    "Rsho", "Lsho", "Lhip",
)

LIMB_FROM = np.array([PARTS_DICT[n] for n in _LIMB_FROM_NAMES], dtype=np.int32)
LIMB_TO = np.array([PARTS_DICT[n] for n in _LIMB_TO_NAMES], dtype=np.int32)
LIMBS_CONN = np.stack([LIMB_FROM, LIMB_TO], axis=1)  # (30, 2)
NUM_LIMBS = len(LIMBS_CONN)  # 30

# Channel layout of the 50-channel regression target / network output.
# reference: config/config.py:125-139  ([0:30]=limb "PAF", [30:48]=keypoints, [48:50]=bg)
PAF_LAYERS = NUM_LIMBS            # 30
HEAT_LAYERS = NUM_PARTS           # 18
NUM_LAYERS = PAF_LAYERS + HEAT_LAYERS + 2  # 50
PAF_START = 0
HEAT_START = PAF_LAYERS           # 30
BKG_START = PAF_LAYERS + HEAT_LAYERS  # 48

# Left/right part index groups swapped on horizontal flip.
# reference: config/config.py:156-162
LEFT_PARTS = np.array([PARTS_DICT[p] for p in
                       ("Lsho", "Lelb", "Lwri", "Lhip", "Lkne", "Lank", "Leye", "Lear")],
                      dtype=np.int32)
RIGHT_PARTS = np.array([PARTS_DICT[p] for p in
                        ("Rsho", "Relb", "Rwri", "Rhip", "Rkne", "Rank", "Reye", "Rear")],
                       dtype=np.int32)

# Channel permutations applied to the flipped prediction before flip-averaging.
# reference: config/config.py:150-152
FLIP_HEAT_ORD = np.array(
    [0, 1, 5, 6, 7, 2, 3, 4, 11, 12, 13, 8, 9, 10, 15, 14, 17, 16, 18, 19],
    dtype=np.int32)
FLIP_PAF_ORD = np.array(
    [0, 2, 1, 4, 3, 6, 5, 8, 7, 12, 13, 14, 9, 10, 11, 18, 19, 20, 15, 16, 17,
     22, 21, 25, 26, 23, 24, 28, 27, 29],
    dtype=np.int32)

# Combined 50-channel flip permutation ([paf, heat(18), bg(2)]).
FLIP_CHANNEL_ORD = np.concatenate([FLIP_PAF_ORD, FLIP_HEAT_ORD + PAF_LAYERS])

# CMU joint id -> COCO keypoint id for evaluation output (None = synthesized neck).
# reference: config/config.py:146-147
DT_GT_MAPPING: Dict[int, Optional[int]] = {
    0: 0, 1: None, 2: 6, 3: 8, 4: 10, 5: 5, 6: 7, 7: 9, 8: 12, 9: 14, 10: 16,
    11: 11, 12: 13, 13: 15, 14: 2, 15: 1, 16: 4, 17: 3,
}

# CMU -> COCO reorder used when dumping result json. reference: evaluate.py:40
ORDER_COCO = np.array([0, 15, 14, 17, 16, 5, 2, 6, 3, 7, 4, 11, 8, 12, 9, 13, 10],
                      dtype=np.int32)

# Limbs drawn by the demo renderer. reference: config/config.py:154
DRAW_LIST = tuple([0] + list(range(5, 21)) + [29])

# COCO source keypoint order (17 joints). reference: config/config.py:174-176
COCO_PARTS = (
    "nose", "Leye", "Reye", "Lear", "Rear", "Lsho", "Rsho", "Lelb",
    "Relb", "Lwri", "Rwri", "Lhip", "Rhip", "Lkne", "Rkne", "Lank", "Rank",
)
COCO_PARTS_DICT: Dict[str, int] = {p: i for i, p in enumerate(COCO_PARTS)}


# ---------------------------------------------------------------------------
# Dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """IMHN architecture hyper-parameters. reference: config/config.py:14-16, models/posenet.py:50-88."""
    nstack: int = 4
    inp_dim: int = 256          # hourglass trunk width
    increase: int = 128         # channel growth per hourglass depth level
    depth: int = 4              # hourglass recursion depth (5 output scales)
    oup_dim: int = NUM_LAYERS   # 50 output channels
    num_scales: int = 5
    bn: bool = True
    se_reduction: int = 16
    # variant switches (reference ablation family, SURVEY C21):
    cross_stack: bool = True        # False = no per-scale cross-stack skips
    legacy_blocks: bool = False     # True = the AE-family IndependentPoseNet
    #                                 (plain-conv stem + old hourglass,
    #                                 models/layers.py + posenet_independent.py)
    extra_attention: bool = False   # True = posenet_final.py channel_attention
    remat: bool = False             # rematerialize hourglass activations
                                    # (trades ~30% step time for ~2x batch)


@dataclasses.dataclass(frozen=True)
class AugmentationConfig:
    """Data-augmentation parameters. reference: config/config.py:25-49."""
    target_dist: float = 0.6
    scale_prob: float = 0.8
    scale_min: float = 0.7
    scale_max: float = 1.3
    max_rotate_degree: float = 40.0
    center_perterb_max: float = 50.0
    flip_prob: float = 0.5
    tint_prob: float = 0.2
    sigma: float = 9.0                     # keypoint gaussian sigma (512 input)
    keypoint_gaussian_thre: float = 0.015
    limb_gaussian_thre: float = 0.015
    paf_sigma: float = 7.0
    paf_thre_factor: float = 1.0           # * stride -> limb bbox end-point margin


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training options. reference: config/config.py:8-22, train_distributed.py."""
    batch_size: int = 4            # per data-parallel shard
    learning_rate: float = 2.5e-5  # per shard; scaled by mesh data-axis size
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nstack_weight: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    scale_weight: Tuple[float, ...] = (0.1, 0.2, 0.4, 1.6, 6.4)
    multi_task_weight: float = 0.1    # person-mask channel loss weight
    keypoint_task_weight: float = 3.0  # keypoint vs limb heatmap weight
    focal_gamma: float = 1.0
    warmup_epochs: int = 3             # linear LR warmup. reference: train_distributed.py:396-414
    lr_step_epochs: int = 15           # divide LR by 5 every N epochs
    lr_step_factor: float = 0.2
    lr_late_epoch: int = 78            # after this, step every 5 epochs
    lr_late_step_epochs: int = 5
    abnormal_loss_thresh: float = 2e5  # skip batch on loss explosion. reference: train_distributed.py:273-275
    max_grad_norm: float = 0.0         # 0 disables clipping (reference had it commented out)
    ckpt_dir: str = "./checkpoints"
    # SWA (reference: train_distributed_SWA.py:111-114, 403-424)
    swa: bool = False
    swa_freq_epochs: int = 5
    swa_lr_max: float = 1e-5
    swa_lr_min: float = 1e-6


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Post-processing thresholds. reference: utils/config:1-40 (INI), pafprocess.h:6-17."""
    scale_search: Tuple[float, ...] = (1.0,)   # reference live path hardcodes [1.]
    thre1: float = 0.1          # keypoint peak threshold
    thre2: float = 0.1          # limb (PAF) sample threshold
    connect_ration: float = 0.8  # fraction of samples that must pass thre2
    mid_num: int = 20            # samples per candidate limb segment
    len_rate: float = 16.0       # limb length prior gate in assembly
    connection_tole: float = 0.7  # merge tolerance in assembly
    offset_radius: int = 2       # sub-pixel refinement window radius
    remove_recon: bool = False   # delete shared joints between two persons
    boxsize: int = 512
    stride: int = 4
    max_downsample: int = 64     # pad image dims to a multiple of this
    pad_value: int = 128
    img_max_h: int = 2600        # input size clamp. reference: parse_skeletons.py:198
    img_max_w: int = 3800
    max_peaks: int = 32          # fixed-size peak table per joint type (device path)
    max_people: int = 40         # fixed-size person table (device path)
    min_person_parts: int = 2    # final cull. reference: parse_skeletons.py:593-598
    min_person_score: float = 0.45


@dataclasses.dataclass(frozen=True)
class CanonicalConfig:
    """Full canonical config bundle (512x512 input, stride 4)."""
    width: int = 512
    height: int = 512
    stride: int = 4
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    aug: AugmentationConfig = dataclasses.field(default_factory=AugmentationConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    infer: InferenceConfig = dataclasses.field(default_factory=InferenceConfig)

    # --- derived skeleton/layout constants (shared across variants) ---
    @property
    def num_parts(self) -> int:
        return NUM_PARTS

    @property
    def paf_layers(self) -> int:
        return PAF_LAYERS

    @property
    def heat_layers(self) -> int:
        return HEAT_LAYERS

    @property
    def num_layers(self) -> int:
        return NUM_LAYERS

    @property
    def heat_start(self) -> int:
        return HEAT_START

    @property
    def bkg_start(self) -> int:
        return BKG_START

    @property
    def limbs_conn(self) -> np.ndarray:
        return LIMBS_CONN

    @property
    def flip_heat_ord(self) -> np.ndarray:
        return FLIP_HEAT_ORD

    @property
    def flip_paf_ord(self) -> np.ndarray:
        return FLIP_PAF_ORD

    @property
    def mask_shape(self) -> Tuple[int, int]:
        return (self.height // self.stride, self.width // self.stride)

    @property
    def parts_shape(self) -> Tuple[int, int, int]:
        return (self.height // self.stride, self.width // self.stride, NUM_LAYERS)

    @property
    def paf_thre(self) -> float:
        return self.aug.paf_thre_factor * self.stride


GROUPS = {"model": ModelConfig, "aug": AugmentationConfig,
          "train": TrainConfig, "infer": InferenceConfig}


def from_file(config: dict) -> CanonicalConfig:
    """The configuration a file of ``configs/`` states: ``width``,
    ``height``, ``stride`` and every field of each group of ``GROUPS``,
    none left to a default (a list stands for a tuple)."""
    groups = {}
    for key, cls in GROUPS.items():
        given = config[key]
        want = {f.name for f in dataclasses.fields(cls)}
        if set(given) != want:
            raise ValueError(f"{config.get('name')}: {key} states "
                             f"{sorted(set(given) ^ want)} wrongly")
        groups[key] = cls(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in given.items()})
    return CanonicalConfig(width=config["width"], height=config["height"],
                           stride=config["stride"], **groups)


def convert_coco_joints(joints: np.ndarray) -> np.ndarray:
    """Convert COCO-order (N,17,3) joints to canonical CMU order (N,18,3).

    Synthesizes the neck as the mean of the shoulders and re-encodes visibility
    to: 0=labeled+invisible, 1=labeled+visible, 2=absent, 3=never in dataset.
    reference: config/config.py:183-251 ``COCOSourceConfig.convert``.
    """
    joints = np.asarray(joints, dtype=np.float64)
    num_obj = joints.shape[0]
    assert joints.shape[1] == len(COCO_PARTS)
    out = np.zeros((num_obj, NUM_PARTS, 3), dtype=np.float64)
    out[:, :, 2] = 3.0
    for name, coco_id in COCO_PARTS_DICT.items():
        cmu_id = PARTS_DICT.get(name)
        if cmu_id is not None:
            out[:, cmu_id, :] = joints[:, coco_id, :]

    neck = PARTS_DICT["neck"]
    r, l = COCO_PARTS_DICT["Rsho"], COCO_PARTS_DICT["Lsho"]
    both = (joints[:, l, 2] < 2) & (joints[:, r, 2] < 2)
    out[~both, neck, 2] = 2.0
    out[both, neck, 0:2] = (joints[both, r, 0:2] + joints[both, l, 0:2]) / 2
    out[both, neck, 2] = np.minimum(joints[both, r, 2], joints[both, l, 2])
    return out
