"""GeoMAE pretrainer: geometric targets, the random mask, the model and the
masked multi-term loss.

Port of ``geomae_tpu/models/mae.py`` (``GeoMAETargets``,
``compute_targets``, ``compute_targets_batch``, ``sample_mask``,
``sample_focal_mask``, ``compact_visible``, ``GeoMAE``,
``pretrain_loss``), batched over a leading axis instead of the JAX
``vmap``.

Targets.  Points arrive in canonical (pillar, slot_sort) order
(``ops/voxelize.py``).  K3 (``ops/targets.slot_outer_segment_sum``) sums
the centred (z, y, x, 1) rows of every (pillar, low slot) into dense
[B, V, 128, 4] tables; the med and top tables are reshape-sums of them
(slot_sort is med-major).  Normals and curvature come from the
covariance of the occupied med centroids over each pillar's 3x3 BEV
neighbourhood: per-pillar moment rows (``_moment_feats``) are expanded
into a dense [ny * nx + 1, 13] grid by K4 (``ops/targets.expand_rows``),
a 9-tap stencil sums them (``_stencil_covs``, plain torch), each pillar
gathers its cell back, and ``ops/eig3`` solves the 3x3 eigenproblem.  On
the CPU K3 and K4 take their plain versions; the path is the same.
Targets carry no gradient (the JAX step's ``stop_gradient``).

Model.  The VFE (``models/vfe.py``), the visible pillars compacted into a
[B, max_visible] buffer through ``ops/scatter.gather_injective``, the SST
encoder over them, the inverse injection back to table rows with the
``mask_token`` at masked rows, then the two decoder branches (centroid,
density) over every pillar.  The JAX package folds the two branches into
one grouped stack (``SSTStackPair``) to halve the TPU's launches; here
they are two ``SSTStack``s on the ported K5 / K6 kernels, which compute
each group of the grouped call as it stands.  Module names follow the
reference checkpoint (``voxel_encoder``, ``backbone.encoder_blocks``,
``backbone.decoder_{centroid,density}_blocks``, ``backbone.mask_token``,
``backbone.decoder_pred_*``, ``backbone.cls_pred_*``).  The low heads keep
the reference's row-major ``slot_low`` columns and permute them at use
into the canonical ``slot_sort`` order of the targets.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import PretrainConfig, VoxelConfig
from ..core.boxes import points_in_boxes
from ..ops.eig3 import normal_and_curvature6
from ..ops.scatter import gather_injective, gather_rows_batched
from ..ops.targets import expand_rows, slot_outer_segment_sum
from ..ops.voxelize import Scene, VoxelTable
from ..ops.windows import INT32_MAX, make_layouts
from ..parallel.distributed import all_reduce_sum, current_group
from .sst import SSTStack, prepare_shift_data
from .vfe import DynamicScatterVFE, Linear

# packed symmetric components (00, 11, 22, 01, 02, 12)
_SYM_I = [0, 1, 2, 0, 0, 1]
_SYM_J = [0, 1, 2, 1, 2, 2]


class GeoMAETargets(NamedTuple):
    """Dense geometric targets, batched; (z, y, x) coordinate order.  The
    low tables are in the canonical slot_sort order."""

    low_occ: torch.Tensor       # [B, V, S_low] bool
    low_tgt: torch.Tensor       # [B, V, S_low, 3] normalised, 0 if empty
    med_occ: torch.Tensor       # [B, V, S_med] bool
    med_tgt: torch.Tensor       # [B, V, S_med, 3]
    centroid_top: torch.Tensor  # [B, V, 3] normalised
    normal: torch.Tensor        # [B, V, 3]
    curv: torch.Tensor          # [B, V, 3] (unsupervised)


def _slot_sort_to_low(voxel: VoxelConfig) -> np.ndarray:
    """Static table ``perm[slot_sort] = slot_low`` (int32 [S_low]): both
    label the in-pillar (z, y, x) cell, slot_sort med-major, slot_low
    row-major."""
    rz, ry, rx = voxel.sub_voxel_ratio_low
    mz, my, mx = voxel.sub_voxel_ratio_med
    fz, fy, fx = rz // mz, ry // my, rx // mx
    z, y, x = np.meshgrid(np.arange(rz), np.arange(ry), np.arange(rx),
                          indexing="ij")
    slot_low = (z * ry * rx + y * rx + x).reshape(-1)
    slot_med = ((z // fz) * (my * mx) + (y // fy) * mx + (x // fx)).reshape(-1)
    intra = ((z % fz) * (fy * fx) + (y % fy) * fx + (x % fx)).reshape(-1)
    out = np.zeros(rz * ry * rx, np.int32)
    out[slot_med * (fz * fy * fx) + intra] = slot_low
    return out


def _normalize_dense(raw: torch.Tensor, coords: torch.Tensor, slot_labels,
                     ratio, voxel: VoxelConfig) -> torch.Tensor:
    """(c - (coor * size + origin)) / size per sub-voxel
    (``normalize_centroid_sub_voxel`` of the reference): ``raw`` [B, V, S,
    3] raw metres, ``coords`` [B, V, 2] pillar (y, x), ``slot_labels``
    int [S] in the row-major layout of ``ratio``."""
    rz, ry, rx = ratio
    vx, vy, vz = voxel.voxel_size
    r = voxel.point_cloud_range
    dev = raw.device
    slot = torch.as_tensor(np.asarray(slot_labels, np.int64), device=dev)
    sz, sy, sx = slot // (ry * rx), (slot // rx) % ry, slot % rx
    cy, cx = coords[..., 0:1].long(), coords[..., 1:2].long()    # [B, V, 1]
    coor = torch.stack([sz.float().expand(cy.shape[:2] + sz.shape),
                        (cy * ry + sy).float(), (cx * rx + sx).float()], -1)
    size = torch.tensor([vz / rz, vy / ry, vx / rx], dtype=torch.float32,
                        device=dev)
    origin = torch.tensor([r[2], r[1], r[0]], dtype=torch.float32,
                          device=dev)
    return (raw - (coor * size + origin)) / size


def _centered_vals4(scene: Scene, v_cap: int):
    """(mu [B, 3], vals4 [B, P, 4]): per-sample-mean-centred (z, y, x, 1)
    rows, 0 at invalid and over-cap points (the centring keeps the f32
    sums small)."""
    valid = scene.valid & (scene.table.point2voxel < v_cap)
    zyx = scene.points[..., :3].flip(-1).float()
    nvalid = valid.sum(-1).clamp_min(1)
    mu = torch.where(valid[..., None], zyx, 0.0).sum(-2) / nvalid[..., None]
    vals4 = torch.cat([torch.where(valid[..., None], zyx - mu[:, None], 0.0),
                       valid[..., None].float()], -1)
    return mu, vals4


def _bev_key(table: VoxelTable, voxel: VoxelConfig) -> torch.Tensor:
    """int32 [B, V]: each pillar's BEV cell y * nx + x, ascending; ny * nx
    at invalid rows."""
    ny, nx = voxel.grid_size
    return torch.where(table.valid, table.coords[..., 0] * nx
                       + table.coords[..., 1], ny * nx).to(torch.int32)


def _centroids(s4: torch.Tensor, mu: torch.Tensor):
    """(occupied, raw centroid) of [..., 4] sums; ``mu`` broadcasts."""
    cnt = s4[..., 3]
    return cnt > 0.5, s4[..., :3] / cnt.clamp_min(1.0)[..., None] + mu


def _level_sums(sums: torch.Tensor, voxel: VoxelConfig):
    """(med [B, V, S_med, 4], top [B, V, 4]) sums from the low ones."""
    B, V, s_low, c = sums.shape
    s_med = voxel.num_slots_med
    med = sums.reshape(B, V, s_med, s_low // s_med, c).sum(3)
    return med, med.sum(2)


def _moment_feats(table: VoxelTable, voxel: VoxelConfig, sums: torch.Tensor,
                  mu: torch.Tensor):
    """(feats [B, V, 13] f32, key [B, V] int32): per pillar [count | S1 (3)
    | packed S2 (6) | top centroid (3)] of its occupied med centroids m,
    moments taken about its own top centroid t (``S1 = sum (m - t)``,
    ``S2 = sum (m - t)(m - t)^T``), and its BEV cell."""
    sums_med, sums_top = _level_sums(sums, voxel)
    occ_med, raw_med = _centroids(sums_med, mu[:, None, None])
    occ_top, top_raw = _centroids(sums_top, mu[:, None])
    top_raw = torch.where(occ_top[..., None], top_raw, 0.0)
    med_table = torch.where(occ_med[..., None], raw_med, 0.0)
    of = occ_med.float()
    mt = med_table - top_raw[:, :, None]
    S1 = torch.einsum("bvs,bvsi->bvi", of, mt)
    S2 = (of[..., None] * mt[..., _SYM_I] * mt[..., _SYM_J]).sum(2)
    feats = torch.cat([of.sum(2)[..., None], S1, S2, top_raw], -1)
    return feats, _bev_key(table, voxel)


def _stencil_covs(dense: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """9-tap neighbourhood covariance [B, ny, nx, 6] (packed) over the
    dense moment grid [B, ny * nx + 1, 13]: for the receiving cell u and
    each neighbour n, ``S2_n + S1_n d^T + d S1_n^T + c_n d d^T`` with
    ``d = t_n - t_u``.  Empty cells hold zero moments and add nothing."""
    B = dense.shape[0]
    grid = dense[:, :-1].reshape(B, ny, nx, 13)
    gp = F.pad(grid, (0, 0, 1, 1, 1, 1))
    tg = grid[..., 10:13]
    acc = torch.zeros((B, ny, nx, 6), dtype=torch.float32,
                      device=dense.device)
    for dy in range(3):
        for dx in range(3):
            nb = gp[:, dy:dy + ny, dx:dx + nx]
            cn, s1, s2 = nb[..., 0:1], nb[..., 1:4], nb[..., 4:10]
            d = nb[..., 10:13] - tg
            di, dj = d[..., _SYM_I], d[..., _SYM_J]
            acc = (acc + s2 + s1[..., _SYM_I] * dj + di * s1[..., _SYM_J]
                   + cn * di * dj)
    return acc


def compute_targets(scene: Scene, cfg: PretrainConfig, sums: torch.Tensor,
                    mu: torch.Tensor, dense: torch.Tensor) -> GeoMAETargets:
    """The target tables from the dense (pillar, slot) sums [B, V, S, 4],
    the centring means [B, 3] and the dense moment grid."""
    table, voxel = scene.table, cfg.voxel
    ny, nx = voxel.grid_size
    B, V = table.valid.shape
    sums_med, sums_top = _level_sums(sums, voxel)
    occ_low, raw_low = _centroids(sums, mu[:, None, None])
    occ_med, raw_med = _centroids(sums_med, mu[:, None, None])
    occ_top, raw_top = _centroids(sums_top, mu[:, None])
    low_norm = _normalize_dense(raw_low, table.coords, _slot_sort_to_low(voxel),
                                voxel.sub_voxel_ratio_low, voxel)
    med_norm = _normalize_dense(raw_med, table.coords,
                                np.arange(voxel.num_slots_med),
                                voxel.sub_voxel_ratio_med, voxel)
    top_norm = _normalize_dense(raw_top[:, :, None], table.coords, [0],
                                (1, 1, 1), voxel)[:, :, 0]
    cov6 = gather_rows_batched(
        _stencil_covs(dense, ny, nx).reshape(B, ny * nx, 6),
        _bev_key(table, voxel))                       # sentinel -> 0
    normal, curv = normal_and_curvature6(cov6)
    vmask = table.valid[..., None]
    return GeoMAETargets(
        low_occ=occ_low,
        low_tgt=torch.where(occ_low[..., None], low_norm, 0.0),
        med_occ=occ_med,
        med_tgt=torch.where(occ_med[..., None], med_norm, 0.0),
        centroid_top=torch.where(occ_top[..., None], top_norm, 0.0),
        normal=torch.where(vmask, normal, 0.0),
        curv=torch.where(vmask, curv, 0.0))


@torch.no_grad()
def compute_targets_batch(scene: Scene, cfg: PretrainConfig) -> GeoMAETargets:
    """Targets of a batch: K3 -> moment rows -> K4 -> stencil -> gather ->
    eig3 (the JAX package's TPU route, ``mae.py:364-398``)."""
    table, voxel = scene.table, cfg.voxel
    ny, nx = voxel.grid_size
    v_cap = table.valid.shape[-1]
    mu, vals4 = _centered_vals4(scene, v_cap)
    sums = slot_outer_segment_sum(vals4, scene.slot_sort, table.point2voxel,
                                  voxel.num_slots_low, v_cap)
    feats, key = _moment_feats(table, voxel, sums, mu)
    dense = expand_rows(feats, key, ny * nx)
    return compute_targets(scene, cfg, sums, mu, dense)


@torch.no_grad()
def sample_mask(generator: torch.Generator, valid: torch.Tensor,
                mask_ratio: float) -> torch.Tensor:
    """Random keep mask [B, V] bool, a subset of ``valid``: per sample keep
    ``floor(n_valid * (1 - mask_ratio))`` rows, those whose uniform draw
    from ``generator`` (on valid's device) lies below that order
    statistic (``get_vanilla_mask_index`` of the reference).  Inside
    ``data_parallel(group)``, ``valid`` holds the rank's B rows of a
    global batch, and the draw is rows ``[rank * B, (rank + 1) * B)`` of
    the whole batch's."""
    B, V = valid.shape
    group = current_group()
    rank, world = (0, 1) if group is None else (group.rank, group.world)
    r = torch.rand((world * B, V), generator=generator,
                   device=valid.device)[rank * B:(rank + 1) * B]
    r = torch.where(valid, r, float("inf"))
    len_keep = torch.floor(valid.sum(1).float() * (1.0 - mask_ratio)).long()
    thr = torch.sort(r, 1).values.gather(1, len_keep.clamp(max=V - 1)[:, None])
    keep = (r < thr) & valid
    return torch.where((len_keep >= V)[:, None], valid, keep)


def focal_foreground(table: VoxelTable, gt_boxes: torch.Tensor,
                     gt_mask: torch.Tensor, voxel: VoxelConfig) -> torch.Tensor:
    """[B, V] bool: the valid pillar rows whose point (coords x voxel
    size + range start, z = 1) lies in one of the ``gt_mask``-ed boxes
    [B, G, >=7] moved to z 0 and made 2 m high, the reference's trick for
    a BEV test."""
    r = voxel.point_cloud_range
    vx, vy = voxel.voxel_size[0], voxel.voxel_size[1]
    coords = table.coords.float()
    centers = torch.stack([coords[..., 1] * vx + r[0],
                           coords[..., 0] * vy + r[1],
                           torch.ones_like(coords[..., 0])], -1)
    boxes = gt_boxes.clone()
    boxes[..., 2], boxes[..., 5] = 0.0, 2.0
    inside = points_in_boxes(centers, boxes) & gt_mask[:, None, :]
    return inside.any(-1) & table.valid


def focal_keep(fg: torch.Tensor, valid: torch.Tensor, u: torch.Tensor,
               mask_ratio: float) -> torch.Tensor:
    """Keep mask [B, V] from the foreground ``fg`` and uniforms ``u`` [B,
    V]: per sample the ``floor(n_fg * (1 - mask_ratio))`` foreground rows
    of the smallest draws, and every valid background row."""
    len_keep = torch.floor(fg.sum(1).float() * (1.0 - mask_ratio)).long()
    r = torch.where(fg, u, float("inf"))
    rank = torch.argsort(torch.argsort(r, dim=1, stable=True), dim=1,
                         stable=True)
    return ((rank < len_keep[:, None]) & fg) | (valid & ~fg)


@torch.no_grad()
def sample_focal_mask(generator: torch.Generator, table: VoxelTable,
                      gt_boxes: torch.Tensor, gt_mask: torch.Tensor,
                      voxel: VoxelConfig, mask_ratio: float) -> torch.Tensor:
    """Foreground-focused keep mask [B, V] (``get_focal_mask_index`` of
    the reference): the pillars of ``focal_foreground`` are masked at
    ``mask_ratio`` by uniform draws from ``generator`` (on the table's
    device), the background is always kept."""
    fg = focal_foreground(table, gt_boxes, gt_mask, voxel)
    u = torch.rand(fg.shape, generator=generator, device=fg.device)
    return focal_keep(fg, table.valid, u, mask_ratio)


def compact_visible(keep: torch.Tensor, vis_cap: int):
    """Kept rows packed into [B, vis_cap]: (vis_idx int32, row indices
    ascending, 0 past the kept rows; vis_valid bool)."""
    V = keep.shape[1]
    iota = torch.arange(V, dtype=torch.int32, device=keep.device)
    rows = torch.where(keep, iota, INT32_MAX)
    order = torch.sort(rows, 1).values[:, :vis_cap]
    vis_valid = order != INT32_MAX
    return torch.where(vis_valid, order, 0), vis_valid


def visible_rows(keep: torch.Tensor, vis_cap: int):
    """The compaction as an injection and its inverse: (vis_raw [B,
    vis_cap], the table row of each visible slot, INT32_MAX past the kept
    rows; rank [B, V], the visible slot of each kept row, INT32_MAX
    elsewhere; vis_valid [B, vis_cap])."""
    vis_idx, vis_valid = compact_visible(keep, vis_cap)
    vis_raw = torch.where(vis_valid, vis_idx, INT32_MAX)
    rank = torch.cumsum(keep, 1, dtype=torch.int32) - 1
    rank = torch.where(keep & (rank < vis_cap), rank, INT32_MAX)
    return vis_raw, rank, vis_valid


def encoder_shift_data(table: VoxelTable, vis_raw: torch.Tensor,
                       vis_valid: torch.Tensor, cfg: PretrainConfig) -> dict:
    """The window layouts of the visible tokens, for the encoder."""
    vis_coords = gather_rows_batched(table.coords, vis_raw)
    return prepare_shift_data(
        make_layouts(vis_coords, vis_valid, cfg.sst, cfg.voxel), vis_valid,
        cfg.sst)


class _Backbone(nn.Module):
    """The reference backbone's modules under their checkpoint names."""

    def __init__(self, cfg: PretrainConfig, device=None):
        super().__init__()
        C = cfg.sst.d_model
        s_low, s_med = cfg.voxel.num_slots_low, cfg.voxel.num_slots_med
        self.encoder_blocks = SSTStack(cfg.sst, cfg.mae.encoder_blocks, device)
        self.decoder_centroid_blocks = SSTStack(cfg.sst, cfg.mae.decoder_blocks,
                                                device)
        self.decoder_density_blocks = SSTStack(cfg.sst, cfg.mae.decoder_blocks,
                                               device)
        self.mask_token = nn.Parameter(torch.zeros(1, C, device=device))
        self.decoder_pred_low = Linear(C, s_low * 3, device=device)
        self.decoder_pred_med = Linear(C, s_med * 3, device=device)
        self.decoder_pred_top = Linear(C, 3, device=device)
        self.decoder_pred_density_top = Linear(C, 3, device=device)
        if cfg.mae.cls_sub_voxel:
            self.cls_pred_low = Linear(C, s_low * 2, device=device)
            self.cls_pred_med = Linear(C, s_med * 2, device=device)

    def decoders(self, x: torch.Tensor, shift_data: dict) -> torch.Tensor:
        """The two decoder branches over the same tokens and shift data:
        [2, B, V, C], branch 0 the centroid, 1 the density."""
        return torch.stack([self.decoder_centroid_blocks(x, shift_data),
                            self.decoder_density_blocks(x, shift_data)])


class GeoMAE(nn.Module):
    """VFE + SST encoder over the visible pillars + the two-branch
    decoder over all pillars + the heads.  Parameters stay float32; the
    model computes in ``cfg.compute_dtype``."""

    def __init__(self, cfg: PretrainConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.voxel_encoder = DynamicScatterVFE(cfg.vfe, cfg.voxel, device)
        self.backbone = _Backbone(cfg, device)
        self._cols: Dict = {}

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def _low_head(self, head: Linear, x: torch.Tensor, k: int) -> torch.Tensor:
        """A low head's outputs in slot_sort order: its weight rows (the
        reference's slot_low columns) permuted at use."""
        if (k, x.device) not in self._cols:
            perm = _slot_sort_to_low(self.cfg.voxel).astype(np.int64)
            cols = (perm[:, None] * k + np.arange(k)).reshape(-1)
            self._cols[(k, x.device)] = torch.from_numpy(cols).to(x.device)
        cols = self._cols[(k, x.device)]
        y = F.linear(x, head.weight[cols].to(x.dtype), head.bias[cols].to(
            x.dtype))
        return y.reshape(x.shape[:2] + (-1, k))

    def forward(self, scene: Scene, keep: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Dense predictions over all [B, V] table rows for the keep mask
        ``keep`` [B, V]: reg_low [B, V, S_low, 3], reg_med [B, V, S_med,
        3], reg_top and nor_top [B, V, 3], cls_low [B, V, S_low, 2] and
        cls_med [B, V, S_med, 2], in the compute dtype."""
        cfg, bb = self.cfg, self.backbone
        table = scene.table
        dt = self.dtype
        feats = self.voxel_encoder(scene, dt)

        vis_raw, rank, vis_valid = visible_rows(keep, cfg.caps.max_visible)
        vis_feats = gather_injective(feats, vis_raw, rank)
        enc_data = encoder_shift_data(table, vis_raw, vis_valid, cfg)
        x = bb.encoder_blocks(vis_feats.to(dt), enc_data)

        # back to table rows; masked rows take the mask token
        enc_full = gather_injective(x, rank, vis_raw)
        dec_in = torch.where(keep[..., None], enc_full, bb.mask_token.to(dt))
        dec_in = torch.where(table.valid[..., None], dec_in, 0.0)
        dec_data = prepare_shift_data(
            make_layouts(table.coords, table.valid, cfg.sst, cfg.voxel),
            table.valid, cfg.sst)
        cent, dens = bb.decoders(dec_in, dec_data)

        B, V = keep.shape
        preds = dict(
            reg_low=self._low_head(bb.decoder_pred_low, cent, 3),
            reg_med=bb.decoder_pred_med(cent).reshape(B, V, -1, 3),
            reg_top=bb.decoder_pred_top(cent),
            nor_top=bb.decoder_pred_density_top(dens),
        )
        if cfg.mae.cls_sub_voxel:
            preds["cls_low"] = self._low_head(bb.cls_pred_low, cent, 2)
            preds["cls_med"] = bb.cls_pred_med(cent).reshape(B, V, -1, 2)
        return preds


def _bce_with_logits(logits: torch.Tensor, target) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits (stable form)."""
    return (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


def pretrain_loss(preds: Dict[str, torch.Tensor], targets: GeoMAETargets,
                  scene: Scene, keep: torch.Tensor,
                  cfg: PretrainConfig) -> Dict[str, torch.Tensor]:
    """The masked multi-term loss in f32 (``forward_loss`` of the
    reference): centroid MSE per occupied sub-voxel of the masked pillars
    at low / med / top (weights 10 / 8 / 10), the normal MSE on masked
    pillars (weight 4, logged as ``loss_curv_around`` like the
    reference), occupancy BCE over 2 logits at low / med (5 / 2), and
    their sum ``loss``.  Inside ``data_parallel(group)`` each term divides
    this rank's sum by the whole batch's count (one all-reduce, no
    gradient), so the terms summed over the ranks are the whole batch's."""
    m = cfg.mae
    mask_rows = scene.table.valid & ~keep
    sel_low = targets.low_occ & mask_rows[..., None]
    sel_med = targets.med_occ & mask_rows[..., None]
    n_low, n_med, n_rows = all_reduce_sum(sel_low.sum(), sel_med.sum(),
                                          mask_rows.sum())

    def sub_reg(pred, sel, tgt, n):
        err = (pred.float() - tgt).square().mean(-1)
        return torch.where(sel, err, 0.0).sum() / n.clamp_min(1)

    def dense_reg(pred, tgt):
        err = (pred.float() - tgt.float()).square().mean(-1)
        return (torch.where(mask_rows, err, 0.0).sum()
                / n_rows.clamp_min(1))

    losses = dict(
        loss_centroid_low=sub_reg(preds["reg_low"], sel_low,
                                  targets.low_tgt, n_low) * m.loss_ratio_low,
        loss_centroid_med=sub_reg(preds["reg_med"], sel_med,
                                  targets.med_tgt, n_med) * m.loss_ratio_med,
        loss_centroid_top=dense_reg(preds["reg_top"], targets.centroid_top)
        * m.loss_ratio_top,
        loss_curv_around=dense_reg(preds["nor_top"], targets.normal)
        * m.loss_ratio_nor,
    )
    if m.cls_sub_voxel:
        def cls(logits, occ):
            lg, t = logits.float(), occ.float()
            bce = _bce_with_logits(lg[..., 0], 1.0 - t) \
                + _bce_with_logits(lg[..., 1], t)
            num = torch.where(mask_rows[..., None], bce, 0.0).sum()
            return num / (n_rows * occ.shape[-1] * 2).clamp_min(1)

        losses["loss_cls_low"] = cls(preds["cls_low"],
                                     targets.low_occ) * m.cls_loss_ratio_low
        losses["loss_cls_med"] = cls(preds["cls_med"],
                                     targets.med_occ) * m.cls_loss_ratio_med
    losses["loss"] = sum(losses.values())
    return losses
