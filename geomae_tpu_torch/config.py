"""Typed configuration tree of the port.

The port's own copy of ``geomae_tpu/config.py``: the same frozen
dataclasses, fields, defaults and presets (a test holds every preset to
its twin field by field), so the port imports nothing of the JAX package.
They replace the reference's mmcv ``Config.fromfile`` and registry.
Presets at the bottom reproduce the shipped GeoMAE configs:

* :func:`geomae_pretrain_nus` —
  ``configs/mae_sst/m_sst_nus_singlestage_curv_07_ssl_dataset_wo_dbsampler_6x_1e-5.py``
* :func:`geomae_finetune_nus` —
  ``configs/pre_sst/m_sst_nus_second_pointpillar_fpn355_222_curv_07_ssl_data_wo_dbsampler_6x_1e-5.py``

Explicit *static capacities* (points per sample, pillars per sample)
give every tensor a fixed shape; rows past the data are masked (see
``ops/voxelize.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def replace(cfg, **kw):
    """Functional update helper (works on any of the dataclasses here)."""
    return dataclasses.replace(cfg, **kw)


def _parse_override(text: str):
    """mmcv ``DictAction`` value semantics (reference ``tools/train.py:
    62-71``): python literals where possible, comma-separated values
    become tuples, bare words stay strings."""
    import ast

    def one(v):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v

    if "," in text:
        items = [one(v) for v in text.split(",") if v != ""]
        return tuple(items)
    return one(text)


def apply_overrides(cfg, options):
    """Dotted-path config overrides on the frozen dataclass tree — the
    ``--cfg-options`` analogue of mmcv's config merge:

        apply_overrides(cfg, ["optim.lr=3e-5", "sst.d_model=256",
                              "voxel.voxel_size=0.2,0.2,8"])

    ``options`` is a list of ``key=value`` strings or a dict.  Unknown
    paths raise AttributeError with the failing path."""
    if not options:
        return cfg
    if not isinstance(options, dict):
        options = dict(opt.split("=", 1) for opt in options)
    for key, raw in options.items():
        val = _parse_override(raw) if isinstance(raw, str) else raw
        parts = key.split(".")
        # walk down, collecting the chain of sub-configs
        chain = [cfg]
        for p in parts[:-1]:
            if not hasattr(chain[-1], p):
                raise AttributeError(f"no config field '{p}' in '{key}'")
            chain.append(getattr(chain[-1], p))
        leaf = parts[-1]
        if not hasattr(chain[-1], leaf):
            raise AttributeError(f"no config field '{leaf}' in '{key}'")
        old = getattr(chain[-1], leaf)
        if isinstance(old, tuple) and not isinstance(val, tuple):
            val = (val,) if not isinstance(val, list) else tuple(val)
        node = dataclasses.replace(chain[-1], **{leaf: val})
        # rebuild the spine
        for parent, name in zip(reversed(chain[:-1]), reversed(parts[:-1])):
            node = dataclasses.replace(parent, **{name: node})
        cfg = node
    return cfg


# ---------------------------------------------------------------------------
# Geometry / voxelization
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VoxelConfig:
    """Pillar grid + sub-voxel layout.

    The reference floors each resolution independently
    (``mmdet3d/ops/voxel/voxelize.py:40-43``); we floor once at the *lowest*
    (finest) resolution and derive coarser levels by integer division, which
    is self-consistent by construction.  Ratios are (z, y, x) like the
    reference config (``configs/mae_sst/...6x_1e-5.py:22-24``).
    """

    point_cloud_range: Tuple[float, float, float, float, float, float] = (
        -51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    voxel_size: Tuple[float, float, float] = (0.256, 0.256, 8.0)  # x, y, z
    # sub-voxel subdivision of one pillar, (z, y, x)
    sub_voxel_ratio_low: Tuple[int, int, int] = (8, 4, 4)
    sub_voxel_ratio_med: Tuple[int, int, int] = (4, 2, 2)

    @property
    def grid_size(self) -> Tuple[int, int]:
        """BEV grid (ny, nx)."""
        r = self.point_cloud_range
        nx = int(round((r[3] - r[0]) / self.voxel_size[0]))
        ny = int(round((r[4] - r[1]) / self.voxel_size[1]))
        return ny, nx

    @property
    def num_slots_low(self) -> int:
        rz, ry, rx = self.sub_voxel_ratio_low
        return rz * ry * rx  # 128 for the shipped config

    @property
    def num_slots_med(self) -> int:
        rz, ry, rx = self.sub_voxel_ratio_med
        return rz * ry * rx  # 16 for the shipped config


@dataclass(frozen=True)
class CapsConfig:
    """Static capacities.  All tensors are padded to these and masked."""

    max_points: int = 262144        # points per sample after range filter
    max_voxels: int = 20480         # non-empty pillars per sample (~15-25k real)
    max_visible: int = 8192         # encoder token cap = ceil(max_voxels * keep) + slack


# ---------------------------------------------------------------------------
# Model components
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VFEConfig:
    """DynamicScatterVFE (reference ``voxel_encoder.py:309-419``)."""

    in_channels: int = 5
    feat_channels: Tuple[int, ...] = (64, 128)
    with_cluster_center: bool = True
    with_voxel_center: bool = True
    with_distance: bool = False
    bn_eps: float = 1e-3
    bn_momentum: float = 0.01


@dataclass(frozen=True)
class SSTConfig:
    """Shifted-window sparse transformer stack.

    Mirrors ``MultiMAESSTSPChoose`` hyper-params
    (``configs/mae_sst/...6x_1e-5.py:129-160``).  ``drop_info`` from the
    reference is intentionally absent: every shipped GeoMAE config is
    drop-free (window capacity 144 == 12*12 ceiling), so region batching
    degenerates to static padding — which is what band attention gives us
    for free (SURVEY.md §8.4, §8.13).
    """

    d_model: int = 128
    nhead: int = 8
    dim_feedforward: int = 256
    window_shape: Tuple[int, int] = (12, 12)       # (x, y)
    shifts: Tuple[Tuple[int, int], ...] = ((0, 0), (6, 6))
    pos_temperature: float = 10000.0
    normalize_pos: bool = False
    activation: str = "gelu"
    # the attention route (models/sst.py): "auto" and "qkv" run the window
    # attention with in-kernel q/k/v projections (K6, ops/attention_qkv.py);
    # "band" and "pallas" project q, k, v with plain Linears and run K8
    # (ops/attention.py); "einsum" the same projections and the plain
    # band_attention
    attention_impl: str = "auto"      # "auto"|"qkv"|"band"|"pallas"|"einsum"
    # the post-attention route: "auto" and "fused" run the fused out-proj +
    # LN1 + FFN + LN2 block (K5, ops/ffn.py); "xla" the unfused chain
    ffn_impl: str = "auto"            # "auto"|"fused"|"xla"
    # token layout for windowed attention: "band" sorts tokens by window
    # (the port's only layout); "tilepack" is a JAX-package layout that
    # the port does not take
    band_layout: str = "band"         # "band"|"tilepack"
    # rematerialize whole SST blocks in the backward (the reference's
    # checkpoint_blocks); the port stores block activations
    remat_blocks: bool = False


@dataclass(frozen=True)
class MAEConfig:
    """GeoMAE pretrain task (``MultiSubVoxelDynamicVoxelNetSSL`` +
    ``MultiMAESSTSPChoose``)."""

    encoder_blocks: int = 6
    decoder_blocks: int = 2
    random_mask_ratio: float = 0.7
    # loss weights, configs/mae_sst/...6x_1e-5.py:26-35
    loss_ratio_low: float = 10.0
    loss_ratio_med: float = 8.0
    loss_ratio_top: float = 10.0
    loss_ratio_nor: float = 4.0          # config key `loss_ratio_low_nor`
    cls_loss_ratio_low: float = 5.0
    cls_loss_ratio_med: float = 2.0
    cls_sub_voxel: bool = True
    normalize_sub_voxel: bool = True
    mse_loss: bool = True


@dataclass(frozen=True)
class SECONDConfig:
    """SECOND conv stages of the fine-tune backbone
    (``backbones/sst_second_pretrained_v1.py:137-167``)."""

    in_channels: int = 128
    out_channels: Tuple[int, ...] = (128, 128, 256)
    layer_nums: Tuple[int, ...] = (3, 5, 5)
    layer_strides: Tuple[int, ...] = (2, 2, 2)
    bn_eps: float = 1e-3
    bn_momentum: float = 0.01


@dataclass(frozen=True)
class FPNConfig:
    """SECONDFPN (``models/necks/second_fpn.py:11-91``)."""

    in_channels: Tuple[int, ...] = (128, 128, 256)
    out_channels: Tuple[int, ...] = (128, 128, 128)
    upsample_strides: Tuple[float, ...] = (1, 2, 4)   # <1 = strided conv down
    bn_eps: float = 1e-3
    bn_momentum: float = 0.01


@dataclass(frozen=True)
class AnchorHeadConfig:
    """Anchor3DHead for nuScenes (``configs/pre_sst/...6x_1e-5.py:128-160`` +
    ``configs/_base_/models/sst_base_nus.py``)."""

    num_classes: int = 10
    in_channels: int = 384
    feat_channels: int = 384
    code_size: int = 9            # x y z w l h yaw vx vy
    # AlignedAnchor3DRangeGenerator: one (range, size) pair per anchor type
    anchor_ranges: Tuple[Tuple[float, ...], ...] = (
        (-49.6, -49.6, -1.80032795, 49.6, 49.6, -1.80032795),
        (-49.6, -49.6, -1.74440365, 49.6, 49.6, -1.74440365),
        (-49.6, -49.6, -1.68526504, 49.6, 49.6, -1.68526504),
        (-49.6, -49.6, -1.67339111, 49.6, 49.6, -1.67339111),
        (-49.6, -49.6, -1.61785072, 49.6, 49.6, -1.61785072),
        (-49.6, -49.6, -1.80984986, 49.6, 49.6, -1.80984986),
        (-49.6, -49.6, -1.763965, 49.6, 49.6, -1.763965),
    )
    anchor_sizes: Tuple[Tuple[float, float, float], ...] = (
        (4.60718145, 1.95017717, 1.72270761),   # car
        (6.73778078, 2.4560939, 2.73004906),    # truck
        (12.01320693, 2.87427237, 3.81509561),  # trailer
        (1.68452161, 0.60058911, 1.27192197),   # bicycle
        (0.7256437, 0.66344886, 1.75748069),    # pedestrian
        (0.40359262, 0.39694519, 1.06232151),   # traffic_cone
        (0.48578221, 2.49008838, 0.98297065),   # barrier
    )
    rotations: Tuple[float, ...] = (0.0, 1.57)
    dir_offset: float = -0.7854
    diff_rad_by_sin: bool = True
    # assigner (configs/_base_/models/sst_base_nus.py:47-56)
    pos_iou_thr: float = 0.6
    neg_iou_thr: float = 0.3
    min_pos_iou: float = 0.3
    code_weight: Tuple[float, ...] = (1.0,) * 7 + (0.2, 0.2)
    # losses
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 1.0
    smooth_l1_beta: float = 1.0 / 9.0
    loss_dir_weight: float = 0.2
    # test cfg (sst_base_nus.py:57-64)
    nms_pre: int = 1000
    nms_thr: float = 0.2
    score_thr: float = 0.05
    max_num: int = 500


@dataclass(frozen=True)
class CenterHeadConfig:
    """CenterHead (CenterPoint) for nuScenes
    (``configs/_base_/models/sst_base_nus_centerhead.py`` +
    ``configs/pre_sst/m_sst_nus_centerhead_second_35_...py:126-145``)."""

    in_channels: int = 512
    share_conv_channel: int = 64
    tasks: Tuple[Tuple[str, ...], ...] = (
        ("car",), ("truck", "construction_vehicle"), ("bus", "trailer"),
        ("barrier",), ("motorcycle", "bicycle"),
        ("pedestrian", "traffic_cone"))
    common_heads: Tuple[Tuple[str, int], ...] = (
        ("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2))
    init_bias: float = -2.19
    norm_bbox: bool = True           # dims regressed in log space
    # targets
    out_size_factor: int = 4
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    max_objs: int = 500
    code_weights: Tuple[float, ...] = (1.0,) * 8 + (0.2, 0.2)
    loss_bbox_weight: float = 0.25
    # test
    score_threshold: float = 0.1
    post_center_range: Tuple[float, ...] = (-61.2, -61.2, -10.0,
                                            61.2, 61.2, 10.0)
    # float = one threshold for all tasks; tuple = per-task thresholds
    # (``use_mul_nms`` of the waymo variant, ``centerpoint_head_waymo.py``)
    nms_thr: float | Tuple[float, ...] = 0.2
    post_max_size: int = 83
    topk: int = 500
    bn_eps: float = 1e-3
    bn_momentum: float = 0.01

    @property
    def num_classes(self) -> int:
        return sum(len(t) for t in self.tasks)


# ---------------------------------------------------------------------------
# Optimization
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimConfig:
    """AdamW + cyclic one-cycle schedule (mmcv ``CyclicLrUpdaterHook``)."""

    lr: float = 1e-5
    weight_decay: float = 0.05
    betas: Tuple[float, float] = (0.9, 0.999)
    grad_clip_norm: float = 10.0
    # cyclic LR: lr ramps to lr*target_ratio[0] over step_ratio_up of training,
    # then anneals to lr*target_ratio[0]*target_ratio[1]
    target_ratio: Tuple[float, float] = (100.0, 1e-3)
    step_ratio_up: float = 0.1
    # cyclic momentum (fine-tune only; None disables)
    momentum_ratio: Optional[Tuple[float, float]] = None
    total_steps: int = 100000
    no_decay_norm: bool = True   # paramwise_cfg custom_keys 'norm' decay_mult=0


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DataConfig:
    data_root: str = "data/nuscenes"
    ann_file: str = "nuscenes_ssl_infos_train.pkl"
    sweeps_num: int = 9
    load_dim: int = 5
    use_dim: int = 5
    batch_size: int = 4            # per chip; global = batch_size * n_chips
    # augmentation, configs/mae_sst/...6x_1e-5.py:183-195
    rot_range: Tuple[float, float] = (-0.3925, 0.3925)
    scale_range: Tuple[float, float] = (0.95, 1.05)
    translation_std: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    flip_ratio_horizontal: float = 0.5
    flip_ratio_vertical: float = 0.5
    shuffle_points: bool = True
    remove_close_radius: float = 1.0


# ---------------------------------------------------------------------------
# Top-level configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PretrainConfig:
    voxel: VoxelConfig = field(default_factory=VoxelConfig)
    caps: CapsConfig = field(default_factory=CapsConfig)
    vfe: VFEConfig = field(default_factory=VFEConfig)
    sst: SSTConfig = field(default_factory=SSTConfig)
    mae: MAEConfig = field(default_factory=MAEConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    compute_dtype: str = "bfloat16"   # transformer compute; fp32 for parity tests
    seed: int = 0


@dataclass(frozen=True)
class FinetuneConfig:
    voxel: VoxelConfig = field(default_factory=lambda: VoxelConfig(
        point_cloud_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
        voxel_size=(0.25, 0.25, 8.0),
    ))
    caps: CapsConfig = field(default_factory=CapsConfig)
    vfe: VFEConfig = field(default_factory=VFEConfig)
    sst: SSTConfig = field(default_factory=SSTConfig)
    num_blocks: int = 6
    second: SECONDConfig = field(default_factory=SECONDConfig)
    fpn: FPNConfig = field(default_factory=FPNConfig)
    head_type: str = "anchor"                 # "anchor" | "center"
    head: AnchorHeadConfig = field(default_factory=AnchorHeadConfig)
    center_head: CenterHeadConfig = field(default_factory=CenterHeadConfig)
    optim: OptimConfig = field(default_factory=lambda: OptimConfig(
        lr=1e-4, weight_decay=0.01, grad_clip_norm=35.0,
        target_ratio=(10.0, 1e-4), step_ratio_up=0.4,
        momentum_ratio=(0.85 / 0.95, 1.0)))
    data: DataConfig = field(default_factory=lambda: DataConfig(
        ann_file="nuscenes_infos_train.pkl"))
    max_gt_boxes: int = 512        # static cap on GT boxes per sample (CBGS-pasted scenes)
    compute_dtype: str = "bfloat16"
    seed: int = 0


def geomae_pretrain_nus(**overrides) -> PretrainConfig:
    """The shipped 72-epoch nuScenes pretrain config (6x, lr 1e-5)."""
    return replace(PretrainConfig(), **overrides) if overrides else PretrainConfig()


def geomae_finetune_nus(**overrides) -> FinetuneConfig:
    """The shipped PointPillars-FPN355 fine-tune config (cyclic 20e)."""
    return replace(FinetuneConfig(), **overrides) if overrides else FinetuneConfig()


def geomae_pretrain_waymo(**overrides) -> PretrainConfig:
    """Waymo multi-sweep pretraining (BASELINE config 5 — a novel
    composition: the reference ships unlabeled-Waymo dataset bases
    (``configs/_base_/datasets/waymo-3d-no-gt-v13.py``) and Waymo SST
    geometry (``configs/sst_refactor/sst_waymoD5...py``: 0.32 m pillars,
    range ±74.88, z in [-2, 4]) but no Waymo pretrain config."""
    voxel = VoxelConfig(
        point_cloud_range=(-74.88, -74.88, -2.0, 74.88, 74.88, 4.0),
        voxel_size=(0.32, 0.32, 6.0))
    caps = CapsConfig(max_points=262144, max_voxels=24576, max_visible=8192)
    data = DataConfig(data_root="data/waymo", ann_file="waymo_infos_train.pkl",
                      sweeps_num=3, load_dim=6, use_dim=5)
    cfg = PretrainConfig(voxel=voxel, caps=caps, data=data)
    return replace(cfg, **overrides) if overrides else cfg


def geomae_finetune_nus_centerhead(**overrides) -> FinetuneConfig:
    """The CenterHead fine-tune variant
    (``configs/pre_sst/m_sst_nus_centerhead_second_35_...py``): 0.256 m
    pillars, SECOND [3, 5] stages, FPN [0.5, 1] -> 512ch at 100x100."""
    cfg = FinetuneConfig(
        voxel=VoxelConfig(
            point_cloud_range=(-51.2, -51.2, -5.0, 51.2, 51.2, 3.0),
            voxel_size=(0.256, 0.256, 8.0)),
        second=SECONDConfig(out_channels=(128, 256), layer_nums=(3, 5),
                            layer_strides=(2, 2)),
        fpn=FPNConfig(in_channels=(128, 256), out_channels=(256, 256),
                      upsample_strides=(0.5, 1)),
        head_type="center",
        center_head=CenterHeadConfig(out_size_factor=4),
    )
    return replace(cfg, **overrides) if overrides else cfg


def tiny_finetune_config() -> FinetuneConfig:
    """Small fine-tune config for CPU tests: 40x40 grid, tiny caps."""
    voxel = VoxelConfig(
        point_cloud_range=(-5.0, -5.0, -5.0, 5.0, 5.0, 3.0),
        voxel_size=(0.25, 0.25, 8.0),
    )
    caps = CapsConfig(max_points=2048, max_voxels=256, max_visible=256)
    vfe = VFEConfig(feat_channels=(16, 32))
    sst = SSTConfig(d_model=32, nhead=4, dim_feedforward=64)
    second = SECONDConfig(in_channels=32, out_channels=(32, 32, 64),
                          layer_nums=(1, 1, 1))
    fpn = FPNConfig(in_channels=(32, 32, 64), out_channels=(32, 32, 32))
    rngs = tuple((-4.8, -4.8, z, 4.8, 4.8, z) for z in
                 (-1.8, -1.74, -1.68, -1.67, -1.61, -1.8, -1.76))
    head = AnchorHeadConfig(in_channels=96, feat_channels=96,
                            anchor_ranges=rngs, nms_pre=128, max_num=32)
    return FinetuneConfig(voxel=voxel, caps=caps, vfe=vfe, sst=sst,
                          num_blocks=2, second=second, fpn=fpn, head=head,
                          max_gt_boxes=32, compute_dtype="float32")


def tiny_finetune_center_config() -> FinetuneConfig:
    """Tiny CenterHead variant for CPU tests."""
    base = tiny_finetune_config()
    return replace(
        base,
        second=SECONDConfig(in_channels=32, out_channels=(32, 64),
                            layer_nums=(1, 1), layer_strides=(2, 2)),
        fpn=FPNConfig(in_channels=(32, 64), out_channels=(32, 32),
                      upsample_strides=(0.5, 1)),
        head_type="center",
        center_head=CenterHeadConfig(
            in_channels=64, share_conv_channel=16, out_size_factor=4,
            max_objs=32, topk=32, post_max_size=16,
            post_center_range=(-10, -10, -10, 10, 10, 10)),
        max_gt_boxes=32)


def tiny_pretrain_waymo_config() -> PretrainConfig:
    """Waymo-geometry pretrain at CPU-test scale: the real Waymo data
    schema (6-channel bins, ego poses, multi-sweep merge) and pillar size
    on a reduced range slice, with the tiny model."""
    base = geomae_pretrain_waymo()
    voxel = VoxelConfig(
        point_cloud_range=(-10.24, -10.24, -2.0, 10.24, 10.24, 4.0),
        voxel_size=(0.32, 0.32, 6.0))
    return replace(
        base, voxel=voxel,
        caps=CapsConfig(max_points=4096, max_voxels=512, max_visible=256),
        vfe=VFEConfig(feat_channels=(16, 32)),
        sst=SSTConfig(d_model=32, nhead=4, dim_feedforward=64),
        mae=MAEConfig(encoder_blocks=2, decoder_blocks=1),
        compute_dtype="float32")


def tiny_pretrain_config() -> PretrainConfig:
    """Small config for CPU tests: 40x40 grid, tiny caps."""
    voxel = VoxelConfig(
        point_cloud_range=(-5.12, -5.12, -5.0, 5.12, 5.12, 3.0),
        voxel_size=(0.256, 0.256, 8.0),
    )
    caps = CapsConfig(max_points=2048, max_voxels=256, max_visible=128)
    vfe = VFEConfig(feat_channels=(16, 32))
    sst = SSTConfig(d_model=32, nhead=4, dim_feedforward=64)
    mae = MAEConfig(encoder_blocks=2, decoder_blocks=1)
    return PretrainConfig(voxel=voxel, caps=caps, vfe=vfe, sst=sst, mae=mae,
                          compute_dtype="float32")
