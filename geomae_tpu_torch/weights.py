"""Flax weights -> this port's ``state_dict``.

The mapping of ``geomae_tpu/train/torch_import.py`` run backwards, so a
checkpoint of the JAX package loads into :class:`~geomae_tpu_torch.models.
detector.DynamicVoxelNet` (fine-tune), :class:`~geomae_tpu_torch.models.
detector.VoxelNet` or :class:`~geomae_tpu_torch.models.mae.GeoMAE`
(pretrain) with ``load_state_dict(strict=True)``:

* Dense ``kernel`` [in, out] -> Linear ``weight`` = kernel.T
* q/k/v projections -> ``in_proj_weight`` / ``in_proj_bias`` (rows q, k, v)
* Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW
* ConvTranspose ``kernel`` -> ConvTranspose2d ``weight`` [in, out, kh, kw],
  spatially flipped back (torch's transposed conv correlates with the
  flipped kernel relative to ``lax.conv_transpose``)
* the VFE's ``voxel_encoder/vfe_{i}/{linear,norm}`` ->
  ``voxel_encoder.vfe_layers.{i}.{linear,norm}``; ``VoxelNet``'s
  ``PillarFeatureNet`` and a ``HardVFE``'s ``{pfn,vfe}_{i}_{linear,norm}``
  -> ``voxel_encoder.{pfn,vfe}_layers.{i}.{linear,norm}``
* BN scale / bias / mean / var -> weight / bias / running_mean /
  running_var (+ ``num_batches_tracked`` = 0); LayerNorm scale -> weight;
* the CenterHead's ``bbox_head/shared_{conv,bn}`` ->
  ``bbox_head.shared_conv.{conv,bn}`` and ``bbox_head/task_{i}/{head}_
  {conv0,bn0,final}`` -> ``bbox_head.task_heads.{i}.{head}.{0.conv,
  0.bn,1}``, the reference ``CenterHead`` / ``SeparateHead``'s names.

SST leaves arrive stacked over blocks (the JAX stack is an ``nn.scan``);
the GeoMAE decoder pair's leaves (``decoders/...``) also over the group
axis G = 2 of the JAX ``SSTStackPair``, whose group 0 is the centroid
branch and 1 the density branch.  ``mask_token`` and the heads carry
across as they are (the heads as Linears).
Every step is a transpose, flip, split or concatenation, linear in the
leaves, so ``from_flax(grads, {})`` also carries a JAX gradient tree into
the port's parameter names (the train-step tests compare gradients so).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}
_HEADS = ("decoder_pred_low", "decoder_pred_med", "decoder_pred_top",
          "decoder_pred_density_top", "cls_pred_low", "cls_pred_med")
_BRANCHES = ("decoder_centroid_blocks", "decoder_density_blocks")


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree)


def _linear(leaf: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    return ("weight", v.T) if leaf == "kernel" else ("bias", v)


def _conv(leaf: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    return ("weight", v.transpose(3, 2, 0, 1)) if leaf == "kernel" \
        else ("bias", v)


def _deconv(v: np.ndarray) -> np.ndarray:
    return v.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _sst_leaf(sd: Dict[str, np.ndarray], base: str, rest: Tuple[str, ...],
              v: np.ndarray) -> None:
    """One EncoderLayer leaf (``v`` for one block) under ``base``."""
    if rest[0] == "win_attn":
        attn = f"{base}.win_attn.self_attn"
        if rest[1] == "out_proj":
            name, val = _linear(rest[2], v)
            sd[f"{attn}.out_proj.{name}"] = val
            return
        row = {"q_proj": 0, "k_proj": 1, "v_proj": 2}[rest[1]]
        key = f"{attn}.in_proj_{'weight' if rest[2] == 'kernel' else 'bias'}"
        parts = sd.setdefault(key, [None] * 3)
        parts[row] = v.T if rest[2] == "kernel" else v
    elif rest[0] in ("linear1", "linear2"):
        name, val = _linear(rest[1], v)
        sd[f"{base}.{rest[0]}.{name}"] = val
    else:                                             # norm1 / norm2
        sd[f"{base}.{rest[0]}.{'weight' if rest[1] == 'scale' else 'bias'}"] \
            = v


def _key(path: Tuple[str, ...], v: np.ndarray, sd: Dict) -> None:
    # the MaskedBatchNorm2d wrapper adds a parameter-free scope
    p = tuple(s for s in path if not s.startswith("MaskedBatchNorm"))
    if p[0] == "voxel_encoder":
        # DynamicScatterVFE: vfe_{i}/{linear,norm}/leaf; PillarFeatureNet
        # and HardVFE: {pfn,vfe}_{i}_{linear,norm}/leaf
        m = re.fullmatch(r"(pfn|vfe)_(\d+)(?:_(linear|norm))?", p[1])
        part, rest = (m.group(3), p[2:]) if m.group(3) else (p[2], p[3:])
        base = f"voxel_encoder.{m.group(1)}_layers.{int(m.group(2))}"
        if part == "linear":
            sd[f"{base}.linear.weight"] = v.T
        else:
            sd[f"{base}.norm.{_BN[rest[0]]}"] = v
    elif p[0] == "encoder" and p[1:3] == ("blocks", "block"):
        j = int(p[3].split("_")[1])
        for i in range(v.shape[0]):
            _sst_leaf(sd, f"backbone.encoder_blocks.{i}.encoder_list.{j}",
                      p[4:], v[i])
    elif p[0] == "decoders" and p[1:3] == ("blocks", "block"):
        j = int(p[3].split("_")[1])
        for i in range(v.shape[0]):
            for g, stack in enumerate(_BRANCHES):
                _sst_leaf(sd, f"backbone.{stack}.{i}.encoder_list.{j}",
                          p[4:], v[i, g])
    elif p[0] == "mask_token":
        sd["backbone.mask_token"] = v
    elif p[0] in _HEADS:
        name, val = _linear(p[1], v)
        sd[f"backbone.{p[0]}.{name}"] = val
    elif p[0] == "second":
        m = re.fullmatch(r"stage(\d+)_(down|conv(\d+))", p[1])
        i = int(m.group(1))
        j = -1 if m.group(2) == "down" else int(m.group(3))
        base = f"backbone.conv_blocks.{i}"
        if p[2] == "conv":
            sd[f"{base}.{3 + 3 * j}.weight"] = _conv("kernel", v)[1]
        else:
            sd[f"{base}.{4 + 3 * j}.{_BN[p[3]]}"] = v
    elif p[0] == "neck":
        m = re.fullmatch(r"deblock(\d+)_(conv|deconv|down|bn)", p[1])
        base = f"neck.deblocks.{int(m.group(1))}"
        if m.group(2) == "bn":
            sd[f"{base}.1.{_BN[p[2]]}"] = v
        elif m.group(2) == "down":
            sd[f"{base}.0.weight"] = _conv("kernel", v)[1]
        else:     # stride >= 1: a ConvTranspose2d in the reference
            sd[f"{base}.0.weight"] = _deconv(v)
    elif p[0] == "bbox_head" and p[1] in ("shared_conv", "shared_bn"):
        if p[1] == "shared_conv":
            sd["bbox_head.shared_conv.conv.weight"] = _conv(p[2], v)[1]
        else:
            sd[f"bbox_head.shared_conv.bn.{_BN[p[2]]}"] = v
    elif p[0] == "bbox_head" and p[1].startswith("task_"):
        # CenterHead: task_{i}/{head}_{conv0,bn0,final}
        head, part = p[2].rsplit("_", 1)
        base = f"bbox_head.task_heads.{int(p[1][5:])}.{head}"
        if part == "conv0":
            sd[f"{base}.0.conv.weight"] = _conv(p[3], v)[1]
        elif part == "bn0":
            sd[f"{base}.0.bn.{_BN[p[3]]}"] = v
        else:
            name, val = _conv(p[3], v)
            sd[f"{base}.1.{name}"] = val
    elif p[0] == "bbox_head":
        name, val = _conv(p[2], v)
        sd[f"bbox_head.{p[1]}.{name}"] = val
    else:
        raise KeyError(f"no port counterpart for flax path {'/'.join(path)}")


def from_flax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``params`` and ``batch_stats`` trees of a fine-tune
    ``DynamicVoxelNet``, a ``VoxelNet`` or a pretrain ``GeoMAE`` (arrays of
    any kind numpy can read) -> the port's ``state_dict``."""
    sd: Dict = {}
    for tree in (params, batch_stats):
        for path, v in _flatten(tree):
            _key(path, v, sd)
    out = {}
    for k, v in sd.items():
        if isinstance(v, list):
            v = np.concatenate(v, 0)
        out[k] = torch.from_numpy(np.array(v, order="C"))   # a copy
        if k.endswith(".running_var"):
            out[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    return out
