"""Smoke run of the PyTorch port's detection serving path, fine-tune train
step, GeoMAE pretrain train step, trainer entry point, data-parallel
training, training from datasets on disk, the CenterHead, the eval entry
point, data preparation, VoxelNet and the point ops on one CUDA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``geomae_tpu_torch/csrc`` with ``nvcc``, then

  A. holds each kernel against its plain PyTorch version on the card, at
     the serving path's shapes (batch 1) and at the train step's (batch 4:
     the forward kernels as the step calls them, K6 with its statistics,
     then the gather, K2 sum and the backward kernels) and at the pretrain
     step's (K3 and K4 at batch 4; K6 with statistics, K5, K7 and K5's
     backward on the encoder's visible tokens), in float32 and bfloat16,
     and times both, and one PyTorch library call of the same function
     where there is one, with CUDA events (K1 and K2 two launches
     bitwise equal, beside the scene's points-per-pillar histogram; K5
     forward and backward in bf16 on the tensor cores, in f32 on the
     CUDA cores; K5's forward two launches bitwise equal); K8 (window
     attention over projected q, k, v) forward and backward (bf16 on
     the tensor cores, f32 on the CUDA cores; two launches bitwise
     equal) and the backward's D
     prologue at all three shapes; the bf16 projections that K6 and K7
     run around K8's kernels (``qkv_project``, ``qkv_project_backward``;
     two launches bitwise equal) at all three shapes; and one
     SST block on the ``band`` route (K8) against the ``qkv`` route (K6)
     with the same weights, at the shipped width and the wide model's;
     then K8 (forward, backward, prologue), K6 (with statistics), K7 and
     the projections' two kernels at every width they take (d_model 128,
     256, 384, 512, 640, 768 and 1024 in heads of 8, 16, 32, 64 and 128,
     128 to 512 also in heads of 1, 2 and 4, 384 in heads of 3, 6, 12,
     24, 48, 96 and 192, 256 and 512 in heads of 256, and 384 and 512 in
     one head) and K5
     (forward, backward) at every (C, F) it takes, on the pretrain
     encoder's tokens, and K1 and K2 as the wide VFE (64, 256) calls
     them, each with its time, bound, library call and each dtype's
     largest error (a ``widths`` JSON line before the kernels line); K5's
     bf16 parameter gradients by three rules (``K5_GRAD_TOL``'s comment)
     with planted faults that must each break one, and K7's and its
     projections' bf16 parameter gradients also by their precision, with
     the gradients rounded to bf16 planted (``k7_precision``);
  B. serves 3 synthetic frames through ``inference_detector`` at the full
     width of ``geomae_finetune_nus()`` in bfloat16, checks the detections
     and that each kernel launched the expected number of times per frame;
  C. runs one frame in float32 through the port on the GPU (kernels) and
     on the CPU (plain versions) from the same seeded weights and compares
     the voxel table, the SST output, the FPN map and the head logits;
  D. trains ``geomae_finetune_nus()`` at full width in bfloat16, batch 4,
     on seeded ``clustered_scene`` batches: finite losses every step, each
     kernel's launches per step, parameters that move, a loss that falls
     over ten steps on one repeated batch, the median step time and the
     peak device memory;
  E. runs one float32 train step (batch 1) on the GPU (kernels) and on
     the CPU (plain versions) from the same seeded weights and batch and
     compares the losses, every parameter's gradient, and the parameters
     and batch statistics after the update;
  F. trains ``geomae_pretrain_nus()`` at full width in bfloat16, batch 4,
     on seeded ``synthetic_batch`` clouds: seven finite loss terms every
     step, each kernel's launches per step, every parameter moved, a loss
     that falls over ten steps on one repeated batch and mask, the median
     step time and the peak device memory;
  G. runs one float32 pretrain step (batch 1) on the GPU (kernels) and on
     the CPU (plain versions) from the same seeded weights, batch and
     mask: the targets, then the losses, gradients, updates and batch
     statistics;
  M. the wide model (``WIDE_OPTIONS``: the VFE at (64, 256), the SST at
     d_model 256 in 8 heads of 32, FFN 512): 3 bf16 pretrain steps at
     batch 4 of ``geomae_pretrain_nus()`` (finite losses, 20 launches a
     step of K8, its backward and prologue, K5 and its backward, the
     median, peak memory, one profiled step's device busy and idle
     share), 2 frames of ``geomae_finetune_nus()`` served, and phase E
     on that model at small caps (one f32 fine-tune step on the card
     against the CPU); then the same on the ``qkv`` route (20 launches a
     step of K6 and K7, 12 of K6 a frame), each route with no call of
     the plain ``band_attention``;
  N. the shipped d_model 128 in 16 heads of 8 and in one head of 128
     (``sst.nhead``; K8, K6 and K7 at D = 8 and 128): on the ``band`` and
     on the ``qkv`` route, 2 bf16 pretrain steps at batch 4 of
     ``geomae_pretrain_nus()`` (seven finite losses, each kernel's
     launches a step, every parameter moved) and one frame of
     ``geomae_finetune_nus()`` served, with no call of the plain
     ``band_attention`` or of the unfused FFN chain; at 16 heads phase G
     at phase M's small caps (one f32 pretrain step on the card against
     the CPU);
  O. the shipped d_model 128 with FFN 128 and 384 (``sst.dim_feedforward``;
     K5 at F of 1 and 3 times C) on the ``band`` route: 2 bf16 pretrain
     steps at batch 4 and one served frame as in N (K5 and its backward
     once a layer a step), with no call of the unfused FFN chain;
  P. d_model 384 in 12 heads of 32, FFN 768, and 512 in 8 heads of 64,
     FFN 1024 (``P_OPTIONS``, the VFE widened to each; K8, K6, K7 and K5
     at C 384 and 512) on the ``band`` and on the ``qkv`` route: 2 bf16
     pretrain steps at batch 4 and one served frame each as in N (20
     launches a step of K8, its prologue and backward, or of K6, K7 and
     the projections' backward, 40 of the projections, and of K5 and its
     backward; 12 of K8 or K6 and of K5 a frame; no plain
     ``band_attention``, no unfused FFN chain), the same on ``band`` at
     512 with FFN 2048 (``P_FFN4``: K5 at (512, 2048)), and d_model 384
     in the shipped 8 heads (of 48) on both routes, in 4 (of 96) on
     ``band`` and in 16 (of 24) and 32 (of 12) on both, FFN 768
     (``P_ODD``: K8, K6 and K7 at head widths that are not a power of
     two), and the wide heads (``P_WIDE_HEADS``: K8, K6 and K7 at D 256,
     192, 384 and 512): d_model 256 in one head, FFN 512, on both routes,
     512 in two, FFN 1024, on both, 384 in two, FFN 768, on ``band``, 384
     in one, FFN 768, and 512 in one, FFN 1024, on both; and the heads
     below 8 (``P_TINY``: K8, K6 and K7 over 8-channel slots): the
     shipped d_model 128, FFN 256, in 32 heads of 4 on both routes and in
     128 of 1 on ``band``, 384 in 64 heads of 6, FFN 768, on ``band``; and
     the wide models (``P_WIDE_C``: K8, K6, K7 and K5 at C 640, 768 and
     1024, K5's tile pass streaming its hidden rows, the projections their
     contraction): d_model 640 in 10 heads of 64, FFN 2560, 768 in 12,
     FFN 3072, and 1024 in 16, FFN 4096, on both routes, with each one's
     peak device memory; then the 512 model's step on each route, the FFN
     2048 model's, the 8-head and the 16-head 384 model's, the two-head
     and one-head 512 model's and the 32-head 128 model's on ``band`` and
     the 768 model's on each route as
     ``profile_pretrain`` times it: median and quartiles, peak memory,
     device busy ms, idle share and the SST kernels' ms a step;
  H. drives the trainer entry point (``python -m geomae_tpu_torch.train``,
     its ``main(argv)`` in process): first the documented ``--tiny`` run
     (pretrain 2 steps, fine-tune 2 from its checkpoint; at that width
     the SST takes its plain routes), then at full width in bfloat16,
     batch 4, on the ``band`` attention route (K8): pretrain to step 3
     with a checkpoint every step, restore that checkpoint into a fresh
     state (bitwise), resume to step 6, fine-tune 4 steps from the
     pretrain checkpoint at the config's lr, and serve 2 frames from the
     fine-tune checkpoint;
  I. data parallelism (``geomae_tpu_torch.parallel``) at the full width
     of ``geomae_pretrain_nus()`` on the ``band`` route: 3 bfloat16
     steps at batch 4 under a one-rank NCCL group, bitwise equal to the
     same steps without a group (losses, parameters, BN buffers), with
     both step times, the gradient all-reduce's bytes and the
     all-reduces a step; two gloo ranks, each a process on the one card
     (NCCL refuses two ranks on one device), one float32 step at batch
     1 a rank against one process on the batch of 2 (phase G's rules,
     tightened: ``DP_TOL``); and ``python -m torch.distributed.run
     --nproc_per_node 1 -m geomae_tpu_torch.train pretrain`` to step 3,
     then resumed to 5;
  J. training from disk: phase A's band-route kernels at the shapes of
     ``geomae_pretrain_waymo()`` (24,576 pillars, a 468 x 468 grid), then
     nuScenes-schema infos (``write_synthetic_infos``: 40 frames of
     50,000 points and 9 sweeps, about 240k points in range) and
     KITTI-format Waymo infos (150,000-point frames with 3 sweeps, past
     the point cap) written to a temporary directory, and the CLI at full
     width, bfloat16, batch 4, band route: pretrain 4 steps from
     ``--data-root`` (the native point prep), fine-tune 4 steps with
     ``--cbgs`` from that checkpoint at the config's lr, one test-mode
     ``NuScenesDetDataset`` frame served from the fine-tune checkpoint
     (finite boxes), and ``--preset waymo`` pretrain 3 steps; each run's
     launches and finite losses, its host ms medians (data wait, step)
     and peak memory, each dataset's host ms per sample, and one
     profiled Waymo step's device busy time;
  K. the CenterHead and evaluation, from phase J's files, at the full
     width of ``geomae_finetune_nus_centerhead()`` (0.256 m pillars, 6
     tasks, 10 classes), bfloat16, band route: ``--preset
     nus_centerhead`` fine-tunes 4 steps at batch 4 through the CLI
     (every task's losses finite, launches per step, host ms medians,
     peak memory, one profiled step's device busy time), 3 distinct
     batches then 4 steps on the last in process (the loss falls), 3
     test-mode frames served from its checkpoint (finite boxes, at most
     ``topk``, labels in [0, 10), scores above the threshold, launches per
     frame as phase B's, one profiled frame) and ``aug_test`` over 4
     flips; phases C and E on the CenterHead config in float32, with the
     NMS keep masks on the card against the CPU on the same candidates;
     ``python -m geomae_tpu_torch.test`` in process on phase J's anchor
     checkpoint over 8 frames with and without ``--wnms`` (finite
     metrics, one results-JSON entry a token, ms a frame); the served
     CenterHead frames scored with ``eval.nuscenes_eval.evaluate``, and
     the ground truth scored as its own prediction at mAP 1.0;
  L. data preparation and the last modules, in phase J's directory:
     ``python -m geomae_tpu_torch.create_data waymo_infos`` (a
     subprocess) on a raw KITTI-format Waymo tree of 12 train and 4 val
     frames of 150,000 points, then ``--preset waymo`` pretrain 3 steps
     from its infos through the CLI and the eval CLI (``--dataset
     waymo``) on them with phase J's anchor checkpoint; ``create_data
     gt_database`` on phase J's nuScenes frames, then 2 bf16 fine-tune
     steps at batch 4 on ``NuScenesDetDataset`` samples with GT paste
     from it (objects pasted and host ms a sample); ``VoxelNet`` at the
     width of ``geomae_finetune_nus()`` with the ``pillar`` and the
     ``simple`` (32 slots) encoder: an f32 frame on the card against the
     CPU (1e-3), the pillar model's f32 gradients (phase E's rule), 10
     bf16 frames served after 3 warm-ups (finite boxes, K1 / K2 launches
     a frame, median and quartiles, one profiled frame), and
     ``HardVFE`` (64, 128) on ``hard_voxelize``'s [4, 20480, 32, 5]
     buffer; FPS 16,384 -> 1,024 points, ``knn(16)``, ``three_nn``,
     ``ball_query(0, 0.4, 32)``, ``three_interpolate`` of 128 channels,
     ``k_medoids`` of [4, 512, 512] into 16 and the focal mask on [4,
     20480] pillars with 40 boxes, each on the card against the CPU
     (indices held exactly where the candidates lie more than
     ``POINT_TOL`` apart).

``auto`` resolves to the ``band`` route at full width.  Phases B, D and F
run first on the ``qkv`` route (K6 and K7, asked for by name), then a
second, shorter time on the ``band`` route, so that the two routes' frame
and step times come from one run and the same batches.  Any failed check
exits non-zero.  The line before the last is a JSON
summary of the kernels: ``launches`` sums the served frames and train steps of
B, D, F (both routes), M, N, O, P, H, I's one-rank NCCL steps, J, K and L; ``ms``,
``plain_ms``, ``library_ms`` and
``bound_ms`` are the times of one call of each distinct call the paths
make of the kernel in its dtype, summed (``segment_broadcast``: f32 mean
+ bf16 max forward at both shapes + f32 sum backward; the SST kernels at
the serving, the decoder and the encoder shapes); ``bound_ms`` is the
least time the card could take for those calls, each call's larger of
its bytes over the HBM rate and its operations over the peak rate of its
dtype (``work``), and ``bound_by`` names the side that sets most of it;
``library_ms`` is null where no single PyTorch call computes the
function; ``max_abs_err`` is the largest over those calls and, for a
backward kernel, over its outputs.  ``band_attention_fused_backward``
is K8's backward kernel alone, timed and bounded from its prologue's D;
the prologue (``band_attention_delta``) is a row of its own, so the two
add up to the wrapper.  The nuScenes shapes' calls make the line's times;
phase J's Waymo-shape rows are printed beside them.  Phase A prints each kernel's and library call's
time behind a device spin (the kernels line's) and at the host's pace
(``probe.cuda_ms``; a kernel's only below ``HOST_PACED_MS``).  The last
line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
FRAMES = 3
DEVICE = "cuda"
DISTINCT = 3         # train steps on distinct batches (the first warms up)
REPEAT = 10          # then steps on the last batch again
BAND_REPEAT = 4      # the repeat of the shorter runs on the band route
BAND_OPTION = "sst.attention_impl=band"
QKV_OPTION = "sst.attention_impl=qkv"   # K6 and K7, no longer the default
# kernel launches per served frame: 6 SST blocks of 2 layers; the VFE's
# cluster mean and max gather-back, and its final pillar max; nothing of
# the backward
PER_FRAME = {"segment_reduce": 1, "segment_broadcast": 2,
             "band_attention_qkv": 12, "post_attention_block": 12,
             "segment_gather": 0, "band_attention_qkv_backward": 0,
             "post_attention_block_backward": 0, "slot_outer_segment_sum": 0,
             "expand_rows": 0, "band_attention_fused": 0,
             "band_attention_fused_backward": 0, "band_attention_delta": 0,
             "qkv_project": 12, "qkv_project_backward": 0}
# per train step: the forward's, then the backward's: K7 and K5's
# backward per layer, the K1 max's gather, the K2 max's K2 sum (the
# decorations' K2 mean carries no gradient); in bf16 K6 projects q, k, v
# once a layer forward and K7 again, then runs the projections' backward
PER_STEP = {"segment_reduce": 1, "segment_broadcast": 2 + 1,
            "band_attention_qkv": 12, "post_attention_block": 12,
            "segment_gather": 1, "band_attention_qkv_backward": 12,
            "post_attention_block_backward": 12, "slot_outer_segment_sum": 0,
            "expand_rows": 0, "band_attention_fused": 0,
            "band_attention_fused_backward": 0, "band_attention_delta": 0,
            "qkv_project": 2 * 12, "qkv_project_backward": 12}


# the wide model of phase M: the VFE widened to 256 channels for an SST of
# d_model 256 in its 8 heads (of 32), FFN 512
WIDE_OPTIONS = ["vfe.feat_channels=64,256", "sst.d_model=256",
                "sst.dim_feedforward=512"]
M_STEPS = 3           # phase M's wide pretrain steps
M_FRAMES = 2          # and its wide served frames
# phase M's f32 wide step against the CPU, at caps small enough for the
# CPU's half to take seconds
M_SMALL_CAPS = ["caps.max_points=32768", "caps.max_voxels=4096",
                "caps.max_visible=2048"]
# phase N: the shipped d_model 128 in heads of 8 and in one head of 128
N_HEADS = (16, 1)
N_STEPS = 2           # bf16 pretrain steps a route
# phase O: the shipped d_model 128 with FFN widths of 1 and 3 times it
O_FFN = (128, 384)
# phase P: the SST at d_model 384 in 12 heads of 32, FFN 768, and at 512
# in 8 heads of 64, FFN 1024, the VFE widened to each; the second timed
P_OPTIONS = {
    384: ["vfe.feat_channels=64,384", "sst.d_model=384", "sst.nhead=12",
          "sst.dim_feedforward=768"],
    512: ["vfe.feat_channels=64,512", "sst.d_model=512", "sst.nhead=8",
          "sst.dim_feedforward=1024"]}
P_TIMED = 512
# and the 512 model with FFN 2048, 4 C (K5 at (512, 2048), its tile pass
# with one hidden row), on band alone, also timed
P_FFN4 = P_OPTIONS[512][:-1] + ["sst.dim_feedforward=2048"]
# and the 384 model in the shipped 8 heads (of 48), in 4 (of 96), in 16
# (of 24) and in 32 (of 12), head widths that are not a power of two: 8
# and 16 heads on band (timed) and on qkv, 4 heads on band, 32 heads on
# band and on qkv
P_ODD = {heads: P_OPTIONS[384][:2] + [f"sst.nhead={heads}"]
         + P_OPTIONS[384][3:] for heads in (8, 4, 16, 32)}
# and the wide heads, (d_model, heads): 256 in one head of 256, FFN 512
# (the VFE at (64, 256)), 512 in two of 256, FFN 1024, 384 in two of
# 192, FFN 768, and 384 and 512 in one head, FFN 768 and 1024: 256 on
# band and qkv, 512 in two on band (timed) and qkv, 384 in two on band,
# 384 and 512 in one on band (512 timed) and qkv
P_WIDE_HEADS = {(256, 1): WIDE_OPTIONS[:2] + ["sst.nhead=1"]
                + WIDE_OPTIONS[2:],
                **{(C, h): P_OPTIONS[C][:2] + [f"sst.nhead={h}"]
                   + P_OPTIONS[C][3:] for C in (512, 384) for h in (2, 1)}}
# and the heads below 8, (d_model, heads): the shipped 128, FFN 256, in 32
# heads of 4 (band, timed, and qkv) and 128 of 1 (band), and 384, FFN 768,
# in 64 heads of 6 (band)
P_TINY = {(128, 32): ["sst.nhead=32"], (128, 128): ["sst.nhead=128"],
          (384, 64): P_OPTIONS[384][:2] + ["sst.nhead=64"]
          + P_OPTIONS[384][3:]}
# and the wide models, by d_model: 640 in 10 heads of 64, FFN 2560, 768
# in 12, FFN 3072 (timed on both routes), 1024 in 16, FFN 4096, the VFE
# widened to each, on band (K8 and K5) and on qkv (K6, K7, the
# projections and K5)
P_WIDE_C = {C: [f"vfe.feat_channels=64,{C}", f"sst.d_model={C}",
                f"sst.nhead={C // 64}", f"sst.dim_feedforward={4 * C}"]
            for C in (640, 768, 1024)}
P_WIDE_TIMED = 768
# the profiled step's SST kernels on each route
# (profile_pretrain.PRETRAIN_KERNELS) and their launches a layer: K8 and
# K5 on band; on qkv also the projections (twice: K6 and K7's recompute),
# their dx and weight-gradient kernels (above C 512 the projections' and
# dx's streamed kernels)
K5_PROFILED = {"post_attention_fwd_tc_kernel": 1,
               "post_attention_bwd_tile_kernel": 1, "wgrad_kernel": 1}
K8_PROFILED = {"band_attention_fwd_tc_kernel": 1,
               "band_attention_delta_kernel": 1,
               "band_attention_bwd_tc_kernel": 1}
P_KERNELS = {
    BAND_OPTION: {**K8_PROFILED, **K5_PROFILED},
    QKV_OPTION: {"qkv_project_kernel": 2, **K8_PROFILED,
                 "qkv_project_dx_kernel": 1, "qkv_wgrad_kernel": 1,
                 **K5_PROFILED}}


def p_kernels(wp, route: str) -> dict:
    """``P_KERNELS[route]`` at ``wp``'s width: above head width 256 K8's
    bf16 backward is ``band_attention_bwd_wide_kernel`` (its two passes in
    one launch); above d_model 512 the projections and their dx run the
    kernels that stream the contraction."""
    ks = dict(P_KERNELS[route])
    if wp.sst.d_model // wp.sst.nhead > 256:
        ks["band_attention_bwd_wide_kernel"] = ks.pop(
            "band_attention_bwd_tc_kernel")
    if wp.sst.d_model > 512 and route == QKV_OPTION:
        for k in ("qkv_project_kernel", "qkv_project_dx_kernel"):
            ks[k.replace("_kernel", "_stream_kernel")] = ks.pop(k)
    return ks


def per_pretrain_step(cfg) -> dict:
    """Kernel launches per pretrain step: the VFE's as in a fine-tune
    step, K3 and K4 once for the targets, and K6, K5, K7 and K5's backward
    once per SST layer: the encoder's and both decoder branches' (2 layers
    a block; 12 + 2 x 4 at the shipped config)."""
    layers = 2 * (cfg.mae.encoder_blocks + 2 * cfg.mae.decoder_blocks)
    sst = ("band_attention_qkv", "post_attention_block",
           "band_attention_qkv_backward", "post_attention_block_backward",
           "qkv_project_backward")
    return dict(PER_STEP, slot_outer_segment_sum=1, expand_rows=1,
                qkv_project=2 * layers, **{k: layers for k in sst})


def on_route(per: dict, cfg) -> dict:
    """``per`` (launches on the ``qkv`` route) on the attention route
    ``cfg`` resolves to (``models.sst.attention_route``): on ``band`` K8
    and its backward take K6's and K7's launches, which fall to 0 with
    the bf16 projections' kernels, and the backward's D prologue launches
    once with each K8 backward."""
    from geomae_tpu_torch.models.sst import attention_route

    sst = cfg.sst
    route = attention_route(sst.attention_impl, sst.d_model, sst.nhead)
    if route == "qkv":
        return per
    assert route == "band", route
    return dict(per, band_attention_qkv=0, band_attention_qkv_backward=0,
                qkv_project=0, qkv_project_backward=0,
                band_attention_fused=per["band_attention_qkv"],
                band_attention_fused_backward=per[
                    "band_attention_qkv_backward"],
                band_attention_delta=per["band_attention_qkv_backward"])
# (atol, rtol) per kernel and dtype, at both shapes.  f32: the kernel and
# the plain version sum in other orders (cuBLAS, atomics).  bf16: the same
# order differences may move a compute-dtype rounding to the other side,
# at the output or at an intermediate point (bias adds, LayerNorm output,
# GELU; K6's probabilities, rounded against a running max); one bf16 ulp
# is at most 2^-7 relative, and 2^-6 = 1.6e-2 absolute for outputs below
# 4.  K6's statistics (log-sum-exp per row and head) at K6's bound.  Max
# is selection, the gather a copy: exact.
# Backward kernels: each per-token cotangent at the same (atol, rtol), its
# atol scaled by its row's largest |reference| and at least 1 (the
# roundings that move a row scale with the row).  Each parameter gradient
# by its largest error against GRAD_TOL of its own largest |reference|,
# or of GRAD_FLOOR of the kernel's largest parameter gradient where its
# own is below that (f32: sums over 80k tokens in another order; bf16: a
# flipped rounding of one token's intermediate moves one term of a sum by
# an ulp).  The floor is for the key bias: its gradient is analytically
# zero (softmax ignores a shift shared by all keys), so its own largest
# value is rounding noise, about 1e-7 of the largest gradient in f32 and
# 1.5e-3 in bf16 (each token's dk rounded to bf16 before the sum), while
# its error is that of the other bias gradients, about 1e-5 of the largest
# in bf16.  The floors lie above both noise levels and below every other
# gradient's own largest value (a quarter of the kernel's largest or
# more), so they reach the key bias alone.  bf16 1e-3 < 2^-9: a bf16
# rounding of the f32 gradients themselves fails.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
GRAD_FLOOR = {torch.float32: 1e-2, torch.bfloat16: 1e-1}
# K5's ten bf16 parameter gradients by three rules, all of which must
# hold.  (1) The kernel against the plain version as above, at
# K5_GRAD_TOL[C] in place of GRAD_TOL: GRAD_TOL's at C 128 and 256.  At C
# 384 and 512 a token's rows are wider and more of its bf16 roundings
# flip between two faithful computations: on the pretrain encoder's
# [4, 8192] tokens at every (C, F) there, over three seeds, the plain
# version read up to 0.96e-3 of max(own, 0.1 x largest) from the f64
# computation (``probe_k5_backward.f64_grads``), the kernel up to
# 1.42e-3, and the plain version with its products on the tensor cores
# (``tensor_core_grads``) as far as the kernel (the tensor cores' f32
# accumulation, not a fault).  The kernel and the plain version may then
# lie up to the sum apart, 2.4e-3; they read up to 1.34e-3.  (2) F5's
# rule: the kernel and the plain version each within
# ``probe_k5_backward.grad_bounds`` of the f64 computation, as the
# ``cuda`` tests hold them.  (2) alone does not see a dropped tile of
# tokens at these shapes (its bound scales with sum |terms| over 32,768
# tokens), so each bf16 row also plants faults (``k5_alongside``): the
# kernel on the same inputs with the cotangent of the K5_FAULT_ROWS-token
# tile around the largest |dy| zeroed must break one of the rules (one
# token read 18.9e-3 or more, 7.5x the bound).  A bf16 rounding of the
# f32 gradients inside the kernel (stored in bf16 they fail the dtype
# check) moves an element by up to 2^-8 of its binade's floor: at C 384
# and 512 (1)'s 2.5e-3 sees it only where a gradient's largest value
# sits low in its binade, and (2) not at all.  (3) The gradients carry
# more than bf16's precision, the kernel's and the plain version's
# (``probe_k5_backward.low_bits_shares``, as the ``cuda`` tests hold
# them).  So the planted faults also hold the kernel's gradients rounded
# to bf16 and stored in f32, which must break a rule.  On the H100
# (``probe_k5_backward phase_a``, three seeds) that rounding read
# 1.09-1.53 of (1)'s bound at C 384 and 512, 0.02-0.04 of (2)'s and 4.0
# of (3)'s; in the kernel's and the plain version's gradients at most
# 0.004 of the elements ended in (3)'s zero bits, 0.016 of its limit.  At
# C 640, 768 and 1024 (``probe_k5_backward phase_a --channels 640 768
# 1024``, every F, three seeds) the kernel read up to 1.76e-3 / 2.06e-3
# / 2.32e-3 from the f64 computation, the plain version up to 0.93e-3 /
# 1.41e-3 / 1.33e-3, the plain version on the tensor cores as far as the
# kernel; their sums, 2.69e-3 / 3.46e-3 / 3.65e-3, set (1) there (the
# kernel and the plain version read up to 1.82e-3 / 1.97e-3 / 2.20e-3
# apart); a dropped token read 7.3 or more of 2.5e-3, the rounding to
# bf16 1.19-1.63 of it and 4.0 of (3)'s limit.
K5_GRAD_TOL = {128: 1e-3, 256: 1e-3, 384: 2.5e-3, 512: 2.5e-3, 640: 2.75e-3,
               768: 3.5e-3, 1024: 3.75e-3}
K5_FAULT_ROWS = (1, 8, 16)
TOL = {
    ("segment_reduce", "max"): {torch.float32: (0.0, 0.0),
                                torch.bfloat16: (0.0, 0.0)},
    ("segment_broadcast", "max"): {torch.float32: (0.0, 0.0),
                                   torch.bfloat16: (0.0, 0.0)},
    ("segment_broadcast", "mean"): {torch.float32: (1e-4, 1e-6),
                                    torch.bfloat16: (1e-6, 2 ** -7)},
    ("band_attention_qkv", ""): {torch.float32: (1e-4, 1e-4),
                                 torch.bfloat16: (2e-2, 2e-2)},
    ("post_attention_block", ""): {torch.float32: (1e-4, 1e-4),
                                   torch.bfloat16: (2e-2, 2e-2)},
    # the train step's own
    ("segment_gather", ""): {torch.float32: (0.0, 0.0),
                             torch.bfloat16: (0.0, 0.0)},
    ("segment_broadcast", "sum"): {torch.float32: (1e-4, 1e-6),
                                   torch.bfloat16: (1e-6, 2 ** -7)},
    # the max backwards through those two kernels, on payloads of a few
    # values, so maxima tie: every tie gets the whole cotangent
    ("segment_reduce_backward", "max"): {torch.float32: (0.0, 0.0),
                                         torch.bfloat16: (0.0, 0.0)},
    ("segment_broadcast_backward", "max"): {
        torch.float32: (1e-4, 1e-6), torch.bfloat16: (1e-6, 2 ** -7)},
    ("post_attention_block_backward", ""): {torch.float32: (1e-4, 1e-4),
                                            torch.bfloat16: (2e-2, 2e-2)},
    ("band_attention_qkv_backward", ""): {torch.float32: (1e-4, 1e-4),
                                          torch.bfloat16: (2e-2, 2e-2)},
    # the pretrain targets' own, f32 only.  K3: the counts (0/1 payloads)
    # exact; a cell's sums of the same n terms in two orders differ by at
    # most 2 (n - 1) 2^-24 sum |terms|, so atol 2^-23 scales by count x
    # sum |terms| per cell.  K4 is a copy: exact.
    ("slot_outer_segment_sum", ""): {torch.float32: (2 ** -23, 0.0)},
    ("expand_rows", ""): {torch.float32: (0.0, 0.0)},
    # K8 at K6's and K7's rules: output and statistics; dq, dk, dv per row
    ("band_attention_fused", ""): {torch.float32: (1e-4, 1e-4),
                                   torch.bfloat16: (2e-2, 2e-2)},
    ("band_attention_fused_backward", ""): {torch.float32: (1e-4, 1e-4),
                                            torch.bfloat16: (2e-2, 2e-2)},
    # K8 backward's prologue, D = rowsum(dO * out): 16 products, exact in
    # f32, added in another order: atol scaled by sum |terms| (``check``)
    ("band_attention_delta", ""): {torch.float32: (15 * 2 ** -24, 0.0),
                                   torch.bfloat16: (15 * 2 ** -24, 0.0)},
    # the bf16 projections of K6 and K7 on the tensor cores (bf16 only:
    # f32 K6 and K7 project inside their CUDA-core kernels): q, k, v at
    # K6's bound; their backward's dx per row and its parameter gradients
    # at K7's rules
    ("qkv_project", ""): {torch.bfloat16: (2e-2, 2e-2)},
    ("qkv_project_backward", ""): {torch.bfloat16: (2e-2, 2e-2)},
}
K8 = [("band_attention_fused", ""), ("band_attention_fused_backward", ""),
      ("band_attention_delta", "")]
PROJECTIONS = [("qkv_project", ""), ("qkv_project_backward", "")]
K5 = [("post_attention_block", ""), ("post_attention_block_backward", "")]
QKV = [("band_attention_qkv", ""), ("band_attention_qkv_backward", "")] \
    + PROJECTIONS
# kernels without atomics, whose two launches must agree bit for bit
DETERMINISTIC = {"band_attention_fused", "band_attention_fused_backward",
                 "band_attention_delta", "post_attention_block",
                 "expand_rows", "qkv_project", "qkv_project_backward",
                 "segment_reduce", "segment_broadcast"}
# the rows at the serving shapes: the serving path's kernels, and K8's
# backward and its prologue and the projections' backward, held there
# too but not summed into the kernels line (a served frame runs no
# backward)
SERVING = list(TOL)[:5] + K8 + PROJECTIONS
NOT_SERVED = {"band_attention_fused_backward", "band_attention_delta",
              "qkv_project_backward"}
TRAIN = list(TOL)[:11] + K8 + PROJECTIONS    # the fine-tune step's rows
# the pretrain step's new rows: the targets' kernels, then the SST kernels
# on the encoder's visible tokens
PRETRAIN = [("slot_outer_segment_sum", ""), ("expand_rows", ""),
            ("band_attention_qkv", ""), ("post_attention_block", ""),
            ("post_attention_block_backward", ""),
            ("band_attention_qkv_backward", "")] + K8 + PROJECTIONS
# phase J's rows at the Waymo pretrain shapes (24,576 pillars, a 468 x 468
# grid): the kernels of the band route's pretrain step
QKV_ROUTE = {"band_attention_qkv", "band_attention_qkv_backward",
             "qkv_project", "qkv_project_backward"}
WAYMO = [k for k in dict.fromkeys(TRAIN + PRETRAIN) if k[0] not in QKV_ROUTE]
# a backward kernel's outputs: its per-token cotangents, then its
# parameter gradients
BACKWARD_OUTPUTS = {
    "post_attention_block_backward": (
        ("dx", "dattn"),
        ("wo", "bo", "s1", "t1", "w1", "b1", "w2", "b2", "s2", "t2")),
    "band_attention_qkv_backward": (
        ("dx",), ("wq", "bq", "wk", "bk", "wv", "bv")),
    "band_attention_fused_backward": (("dq", "dk", "dv"), ()),
    "qkv_project_backward": (("dx",), ("wq", "bq", "wk", "bk", "wv", "bv")),
}
# the dtype each call of the two paths runs in
PATH_DTYPE = {("segment_reduce", "max"): torch.bfloat16,
              ("segment_broadcast", "mean"): torch.float32,
              ("segment_broadcast", "max"): torch.bfloat16,
              ("band_attention_qkv", ""): torch.bfloat16,
              ("post_attention_block", ""): torch.bfloat16,
              ("segment_gather", ""): torch.bfloat16,
              ("segment_broadcast", "sum"): torch.float32,
              ("post_attention_block_backward", ""): torch.bfloat16,
              ("band_attention_qkv_backward", ""): torch.bfloat16,
              ("slot_outer_segment_sum", ""): torch.float32,
              ("expand_rows", ""): torch.float32,
              ("band_attention_fused", ""): torch.bfloat16,
              ("band_attention_fused_backward", ""): torch.bfloat16,
              ("band_attention_delta", ""): torch.bfloat16,
              ("qkv_project", ""): torch.bfloat16,
              ("qkv_project_backward", ""): torch.bfloat16}
KERNELS = {
    "segment_reduce": ("geomae_tpu_torch/csrc/segment.cu",
                       "geomae_tpu/ops/pallas_segreduce.py:220"),
    "segment_broadcast": ("geomae_tpu_torch/csrc/segment.cu",
                          "geomae_tpu/ops/pallas_segreduce.py:553"),
    "band_attention_qkv": ("geomae_tpu_torch/csrc/window_attention.cuh",
                           "geomae_tpu/ops/pallas_attention_qkv.py:928"),
    "post_attention_block": ("geomae_tpu_torch/csrc/post_attention.cuh",
                             "geomae_tpu/ops/pallas_ffn.py:338"),
    "segment_gather": ("geomae_tpu_torch/csrc/segment.cu",
                       "geomae_tpu/ops/pallas_segreduce.py:710"),
    "band_attention_qkv_backward": (
        "geomae_tpu_torch/csrc/window_attention.cuh",
        "geomae_tpu/ops/pallas_attention_qkv.py:724"),
    "post_attention_block_backward": (
        "geomae_tpu_torch/csrc/post_attention.cuh",
        "geomae_tpu/ops/pallas_ffn.py:287"),
    "slot_outer_segment_sum": ("geomae_tpu_torch/csrc/targets.cu",
                               "geomae_tpu/ops/pallas_segreduce.py:345"),
    "expand_rows": ("geomae_tpu_torch/csrc/targets.cu",
                    "geomae_tpu/ops/pallas_segreduce.py:777"),
    "band_attention_fused": ("geomae_tpu_torch/csrc/band_attention.cuh",
                             "geomae_tpu/ops/pallas_attention.py:545"),
    "band_attention_fused_backward": (
        "geomae_tpu_torch/csrc/band_attention.cuh",
        "geomae_tpu/ops/pallas_attention.py:422"),
    # the einsum that _pallas_backward runs before its two kernels
    "band_attention_delta": ("geomae_tpu_torch/csrc/band_attention.cuh",
                             "geomae_tpu/ops/pallas_attention.py:431"),
    # the projections inside K6's and K7's pallas_calls, which the bf16
    # port runs as kernels of their own around K8's
    "qkv_project": ("geomae_tpu_torch/csrc/window_attention.cuh",
                    "geomae_tpu/ops/pallas_attention_qkv.py:291"),
    "qkv_project_backward": ("geomae_tpu_torch/csrc/window_attention.cuh",
                             "geomae_tpu/ops/pallas_attention_qkv.py:789"),
}
# The least time of a call: each input row the data uses read once and
# each output written once over the HBM rate, or the call's arithmetic (2
# operations a multiply-add) over the dense peak of its dtype, whichever
# is larger.  One H100 SXM by NVIDIA's data sheet, at 700 W.
HBM_BYTES_PER_S = 3.35e12
HOST_PACED_MS = 1.0     # phase A times shorter calls at the host's pace too
# phase A times a plain version or a library call of LONG_CALL_MS or more,
# and a kernel of LONG_KERNEL_MS or more, by its first call alone (at 128
# to 512 heads of 1 or 2 the plain attention takes about 1.5 s a call,
# SDPA 0.35-0.8 s, the f32 K5 backward over tiles of 4 tokens at C 640
# and more several hundred ms, f32 K6 and K7 over tiles of 4 tokens at C
# 640 to 1024 about 0.1-1 s; repeating every plain and library call of
# 20 ms or more took about 130 s of the run at C 128 to 1024); every
# shorter one as before
LONG_CALL_MS = 20.0
LONG_KERNEL_MS = 100.0
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PARITY_TOL = (1e-3, 1e-3)      # f32 GPU against CPU, whole model
# the band route against the qkv route, same weights: the two compute one
# function (the projections round, then add their bias, inside K6 and
# outside K8).  In bf16 both run K8's forward on the tensor cores after
# projections that accumulate 16-k steps in f32 on the tensor cores (K6's
# qkv_project, the band route's three Linears), so they round alike.  In
# f32 a layer and a block are held to each other at the kernels' own
# bounds, and so is the bf16 layer.  In bf16 post-norm layers carry a
# flipped rounding (an ulp of an activation between 2 and 4 is 1.6e-2)
# through both LayerNorms, and two layers compound them (the block read
# 1.32 of the layer's bound in its first run), so the bf16 block is held
# at twice the bound; each route's bf16 layer is also held to its own
# f32 layer at LAYER_F32_LIMIT of the bound.  ``python -m
# geomae_tpu_torch.probe_routes`` (four seeds, H100): band against qkv
# reads 0.000 in bf16 (1.02-1.22 with a K6 that rounded its probabilities
# per key beside K8's per chunk, 0.76-0.92 when both rounded per key), a
# sound layer 1.21-1.46 of the bound from its f32 layer; with the band
# route's attention rounded to 6 or 5 mantissa bits 1.31-1.64 (no check
# at one layer tells those from sound), to fp8 e4m3's 3 bits 3.46-4.20,
# with the last key of every window dropped 118-142.
ROUTE_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
BLOCK_FACTOR = {torch.float32: 1, torch.bfloat16: 2}
LAYER_F32_LIMIT = 2.0
# phase E, f32 GPU against CPU, one train step.  The forwards agree to
# about 2e-5 relative (f32 sums in other orders), and every pre-activation
# within that distance of 0 may take the other side of a ReLU on the other
# device: its gradient is then g on one and 0 on the other.  Such flips
# give a relative norm error of about sqrt(flipped share), 5e-3 to 1e-2
# upstream of the 19 ReLUs of SECOND and the FPN (measured layer by
# layer: 1e-5 before the FPN's ReLU backward, 1e-3 after it), while the
# same step run twice on one device agrees to 4e-5.  So the gradients are
# held to 2e-2 relative norm; each kernel's own gradients are held to
# 1e-4 in phase A.
STEP_TOL = {
    "loss": 1e-5,            # relative
    "grad": 2e-2,            # relative norm error, each parameter
    "stats": (1e-5, 1e-4),   # BN running mean / var (atol, rtol)
    # AdamW's first update is about lr * sign(g), so it is held to 1e-3
    # lr where the two devices' gradients agree in sign and |g| exceeds a
    # tenth of its tensor's root mean square; elsewhere (a sign flipped by
    # the gradient noise above, which the gradient bound holds; a |g| near
    # AdamW's eps; the key bias's gradient, zero but for rounding) to 2 lr
    "update": (1e-3, 0.1, 2.001),
    # each side rounds the updated weight once: a BN scale at 1.0 moved by
    # lr 1e-4 lands one f32 ulp apart (1.19e-7, 1.19e-3 lr) when the two
    # updates straddle a rounding boundary (the CenterHead's 37 BNs met
    # it), so both are held beyond two ulps of the weight, as phase G is
    "ulps": 2,
}
# phase G, f32 GPU against CPU, one pretrain step.  The targets: the
# occupancy exact; the centroids in metres (a normalised target times its
# sub-voxel edge) at 2e-5 m, five f32 ulps of a coordinate 32-64 m out:
# a centroid is its points' sum over their count plus the sample mean,
# and the mean (a reduction over about 120k points) and the med and top
# sums (of 8 and 128 sub-voxel sums) add in other orders on the two
# devices, each rounding worth an ulp of 3.8e-6 m there (three measured
# on the top centroids, 1.14e-5 m); the normals' axes at 1 - |cos| <=
# 1e-4 on pillars whose two smallest eigenvalues lie apart (ROADMAP.md
# R1), their signs counted.  The step runs on the CPU's
# targets on both devices, so it holds the model and its kernels: the
# encoder and decoders have no ReLU (GELU is smooth), so only the VFE's
# two ReLUs can flip between devices, upstream of everything else; the
# gradients are held at 1e-3 relative norm.  The lr is 1e-5 at step 0,
# where an f32 ulp of a weight of 0.25 is 3e-3 lr, so each side's own
# rounding of the updated weight (two ulps) adds to the update bound.
PRETRAIN_STEP_TOL = dict(STEP_TOL, grad=1e-3, ulps=2)
# phase I, two gloo ranks against one process, one float32 pretrain step
# on the card: the same kernels on rows split over two ranks, so sums in
# another order, the BN moments and the gradients summed over the ranks.
# Measured (H100 80GB HBM3, 700 W): losses 1.4e-6 relative, gradients 1.5e-4
# relative norm (the VFE's first layer), updates 2.7e-7 lr with no sign
# flip, so the gradient and update bounds are phase G's tightened to
# about 3x and 40x what the card shows
DP_TOL = dict(PRETRAIN_STEP_TOL, grad=5e-4, update=(1e-5, 0.1, 2.001),
              stats=(1e-5, 2e-4))
CENTROID_TOL_M = 2e-5
NORMAL_TOL = 1e-4


class Failed(Exception):
    pass


def compare(label: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float, failures: list, scale=None,
            scale_name: str = "max(1, row's max |ref|)") -> float:
    """``got`` within atol (times ``scale``, per element, where given)
    plus rtol relative of ``want``; returns the largest absolute error."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = atol * (1.0 if scale is None else scale) + rtol * w.abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    ok = bool(torch.isfinite(g).all()) and g.shape == w.shape and not bool(
        (err > bound).any())
    # the largest error as a share of its own bound: 1 is the limit
    pos = bound > 0
    share = f", worst share of bound {float((err[pos] / bound[pos]).max()):.3f}" \
        if (atol or rtol) and bool(pos.any()) else ""
    rows = "" if scale is None else f" x {scale_name}"
    print(f"  {label}: max_abs_err {max_abs:.3e} (atol {atol:g}{rows}, rtol "
          f"{rtol:g}{share}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(label)
    return max_abs


def dbk_rule(name: str, args):
    """The key bias's gradient (analytically 0) by its own rule: (bound,
    whether it holds |dbk| of the kernel and the plain version, else
    |their difference|).  K7's, in both dtypes: F3's forward-error bound
    of the sum of f32 dk rounded to the dtype (``probe_qkv.dbk_bound``,
    from the plain backward's f32 dk); the projections' backward (bf16)
    sums the bf16 dk it is given, the same terms in two orders: 2 n 2^-24
    sum |dk| per channel, n = B V rows."""
    from geomae_tpu_torch import probe_qkv
    from geomae_tpu_torch.ops import attention_qkv

    if name == "band_attention_qkv_backward":
        dk = attention_qkv.attention_grads_plain(*args[:12], args[13])[1]
        return probe_qkv.dbk_bound(dk, args[0].dtype), True
    dk = args[6]
    n = dk.shape[0] * dk.shape[1]
    return 2 * n * 2.0 ** -24 * dk.float().abs().sum((0, 1)), False


def grad_shares(got, want, tol: float, floor: float) -> list:
    """Each parameter gradient's largest error against ``want`` over tol
    x max(its own largest |want|, floor x the largest of all)."""
    top = max(float(b.abs().max()) for b in want)
    return [float((a.double() - b.double()).abs().max())
            / (tol * max(float(b.abs().max()), floor * top))
            for a, b in zip(got, want)]


def k5_alongside(label: str, args, got, want, tol: float,
                 failures: list) -> None:
    """K5's ten bf16 parameter gradients (``got``: the kernel's, ``want``:
    the plain version's) by F5's rule and by their precision, beside the
    kernel-against-plain rule that ``compare_grads`` applied at ``tol``:
    both the kernel and the plain version within
    ``probe_k5_backward.grad_bounds`` of the f64 computation, and with at
    most ``probe_k5_backward.LOW_BITS_SHARE`` of a gradient's elements
    ending in ``LOW_BITS`` zero bits.  Prints each one's distance from the
    f64 computation under the kernel-against-plain metric too, and plants
    faults, each of which must break one of the three rules: the dropped
    tiles of K5_FAULT_ROWS, and the kernel's gradients rounded to bf16
    (stored in f32)."""
    from geomae_tpu_torch import probe_k5_backward as k5
    from geomae_tpu_torch.ops import ffn

    floor = GRAD_FLOOR[torch.bfloat16]
    exact, bounds = k5.f64_grads(args), k5.grad_bounds(args)
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)

    def broken(fault):
        """The planted ``fault``'s shares of each rule's limit, and whether
        one of them breaks its rule."""
        shares = (grad_shares(fault, want, tol, floor),
                  k5.rule_shares(fault, exact, bounds),
                  [s / k5.LOW_BITS_SHARE for s in k5.low_bits_shares(fault)])
        return (f"share of the bound above {fmt(shares[0])}; of F5's "
                f"{fmt(shares[1])}; of the low-bits limit "
                f"{fmt(shares[2])}"), max(max(x) for x in shares) > 1

    for who, grads in (("kernel", got), ("plain", want)):
        f5 = k5.rule_shares(grads, exact, bounds)
        low = k5.low_bits_shares(grads)
        print(f"  {label} {who}: share of F5's bound {fmt(f5)}; distance "
              f"from f64 as a share of the bound above "
              f"{fmt(grad_shares(grads, exact, tol, floor))}; elements "
              f"ending in {k5.LOW_BITS} zero bits {fmt(low)}")
        if max(f5) > 1:
            failures.append(f"{label} {who}: F5's rule")
        if max(low) > k5.LOW_BITS_SHARE:
            failures.append(f"{label} {who}: gradients short of f32 "
                            "precision")
    print(f"  {label} plain, products on the tensor cores: distance from "
          f"f64 as a share of the bound above {fmt(grad_shares(
              k5.tensor_core_grads(args), exact, tol, floor))}")
    faults = {f"with a {rows}-token tile dropped": lambda rows=rows:
              ffn.post_attention_block_backward(
                  *k5.dropped_token(args, rows))[2:]
              for rows in K5_FAULT_ROWS}
    faults["rounded to bf16"] = lambda: [g.bfloat16().float() for g in got]
    for what, fault in faults.items():
        text, caught = broken(fault())
        print(f"  {label} {what}: {text}")
        if not caught:
            failures.append(f"{label}: the gradients {what} pass")


def k7_precision(label: str, params, got, want, tol: float,
                 failures: list) -> None:
    """bf16 K7's and its projections' parameter gradients (``got``: the
    kernel's, ``want``: the plain version's, named ``params``) by their
    precision, beside the kernel-against-plain rule ``compare_grads``
    applied at ``tol``: at most ``probe_k5_backward.LOW_BITS_SHARE`` of a
    gradient's elements ending in ``LOW_BITS`` zero bits, K5's third rule.
    The key bias's gradient is left out (its own rule, ``dbk_rule``: it
    is the rounding noise of an analytically zero sum).  K7's
    kernel-against-plain rule (``probe_qkv.wgrad_tol``: 3e-3 to 1.5e-2,
    above the function's bf16 noise at every width) would pass a bf16
    rounding of the f32 gradients, which moves an element by up to 2^-8
    of its binade's floor; so the kernel's gradients rounded to bf16
    (stored in f32) are planted, and must break one of the two rules."""
    from geomae_tpu_torch import probe_k5_backward as k5

    keep = [i for i, p in enumerate(params) if p != "bk"]
    pick = lambda gs: [gs[i] for i in keep]
    fmt = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
    for who, grads in (("kernel", got), ("plain", want)):
        low = k5.low_bits_shares(pick(grads))
        print(f"  {label} {who}: elements ending in {k5.LOW_BITS} zero bits "
              f"(d{', d'.join(params[i] for i in keep)}) {fmt(low)}")
        if max(low) > k5.LOW_BITS_SHARE:
            failures.append(f"{label} {who}: gradients short of f32 "
                            "precision")
    rounded = pick([g.bfloat16().float() for g in got])
    above = grad_shares(rounded, pick(want), tol, GRAD_FLOOR[torch.bfloat16])
    low = [x / k5.LOW_BITS_SHARE for x in k5.low_bits_shares(rounded)]
    print(f"  {label} rounded to bf16: share of the bound above "
          f"{fmt(above)}; of the low-bits limit {fmt(low)}")
    if max(above + low) <= 1:
        failures.append(f"{label}: the gradients rounded to bf16 pass")


def compare_grads(label: str, name: str, got, want, dtype, tol,
                  failures: list, args=None) -> float:
    """A backward kernel's outputs (BACKWARD_OUTPUTS): the cotangents at
    ``tol`` with atol scaled per row, each parameter gradient against
    GRAD_TOL of max(its own largest |want|, GRAD_FLOOR x the largest); the
    key bias of K7 (both dtypes) and of the projections' backward (bf16)
    by ``dbk_rule``; in bf16 K7's other parameter gradients at
    ``probe_qkv.wgrad_tol`` of its width, and K7's and the projections'
    backward's also by their precision (``k7_precision``), and K5's ten
    parameter gradients at K5_GRAD_TOL of its C and by F5's rule
    alongside (``k5_alongside``).  Returns the largest absolute error."""
    tokens, params = BACKWARD_OUTPUTS[name]
    n = len(tokens)
    rows = lambda t: t.flatten(2)         # [B, V, H, D] -> [B, V, C]
    errs = [compare(f"{label} {t}", rows(a), rows(b), *tol, failures,
                    scale=rows(b).float().abs().amax(-1, keepdim=True)
                    .clamp_min(1))
            for t, a, b in zip(tokens, got, want)]
    if not params:
        return max(errs)
    k5 = name == "post_attention_block_backward" and \
        dtype == torch.bfloat16 and args is not None
    k7 = name == "band_attention_qkv_backward" and args is not None
    grad_tol = K5_GRAD_TOL[args[0].shape[-1]] if k5 else GRAD_TOL[dtype]
    if k7 and dtype == torch.bfloat16:
        from geomae_tpu_torch import probe_qkv
        C = args[0].shape[-1]
        grad_tol = probe_qkv.wgrad_tol(C, C // args[10])
    top = max(float(b.abs().max()) for b in want[n:])
    shares = []
    for p, a, b, share in zip(params, got[n:], want[n:], grad_shares(
            got[n:], want[n:], grad_tol, GRAD_FLOOR[dtype])):
        own = float(b.abs().max())
        if p == "bk" and args is not None and (k7 or dtype == torch.bfloat16):
            bound, to_zero = dbk_rule(name, args)
            gaps = (a.abs(), b.abs()) if to_zero else ((a - b).abs(),)
            share = max(float((t / bound).max()) for t in gaps)
        errs.append(float((a.float() - b.float()).abs().max()))
        shares.append(f"d{p} {own:.2e}: {share:.3f}")
        if not (a.dtype == torch.float32 and a.shape == b.shape
                and bool(torch.isfinite(a).all()) and share <= 1):
            failures.append(f"{label} d{p}")
    rule = " (dbk: dbk_rule's)" if "bk" in params and args is not None \
        and (k7 or dtype == torch.bfloat16) else ""
    print(f"  {label} parameter gradients, largest |ref| and share of the "
          f"bound {grad_tol:g} x max(own, {GRAD_FLOOR[dtype]:g} x "
          f"{top:.3e}){rule}: {'; '.join(shares)}")
    if k5:
        k5_alongside(label, args, got[n:], want[n:], grad_tol, failures)
    elif dtype == torch.bfloat16 and args is not None:
        k7_precision(label, params, got[n:], want[n:], grad_tol, failures)
    return max(errs)


def check(label: str, name: str, got, want, dtype, tol, failures: list,
          args) -> float:
    """One phase-A row: a backward kernel's outputs, K6's output and
    statistics, K3's counts and sums, or one tensor."""
    if name == "slot_outer_segment_sum":
        from geomae_tpu_torch.ops.targets import slot_outer_segment_sum_plain
        vals, slot, seg, S, V = args
        mag = slot_outer_segment_sum_plain(vals.abs(), slot, seg, S, V)
        return max(compare(f"{label} counts", got[..., 3], want[..., 3], 0.0,
                           0.0, failures),
                   compare(f"{label} sums", got[..., :3], want[..., :3],
                           *tol, failures, scale=want[..., 3:] * mag[..., :3],
                           scale_name="count x sum |terms|"))
    if name in BACKWARD_OUTPUTS:
        return compare_grads(label, name, got, want, dtype, tol, failures,
                             args)
    if name == "band_attention_delta":
        from geomae_tpu_torch.ops.attention import band_attention_delta_plain
        out, g, win_id = args
        return compare(label, got, want, *tol, failures,
                       scale=band_attention_delta_plain(out.abs(), g.abs(),
                                                        win_id),
                       scale_name="sum |terms|")
    if isinstance(got, tuple):
        parts = ("q", "k", "v") if name == "qkv_project" else ("out", "lse")
        return max([compare(f"{label} {part}", a, b, *tol, failures)
                    for part, a, b in zip(parts, got, want)])
    return compare(label, got, want, *tol, failures)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def window_stats(win_id: torch.Tensor):
    """(tokens, windows, sum over windows of size^2, size histogram) of a
    window-sorted layout [B, V]."""
    n, wins, pairs, sizes = 0, 0, 0, []
    for w in win_id:
        w = w[w != 2 ** 31 - 1]
        c = torch.unique_consecutive(w, return_counts=True)[1].long()
        n, wins, pairs = n + w.numel(), wins + c.numel(), \
            pairs + int((c * c).sum())
        sizes.append(c.cpu())
    edges = [1, 2, 5, 9, 17, 33, 65, 129, 145]
    hist = torch.histogram(torch.cat(sizes).float(),
                           torch.tensor(edges, dtype=torch.float32))
    return n, wins, pairs, {f"{a}-{b - 1}": int(h) for a, b, h in zip(
        edges, edges[1:], hist.hist)}


def work(name: str, args, got):
    """(bytes, operations) of one call on this run's data: each input row
    the data uses read once, each output written once; 2 operations a
    multiply-add, the projections and the pairs of tokens that share a
    window (attention), the rows up to each sample's extent (K5)."""
    outs = got if isinstance(got, tuple) else (got,)
    out_b = nbytes(*outs)
    if name in ("segment_reduce", "segment_broadcast"):
        x, seg, V, _ = args
        n, C = int((seg < V).sum()), x.shape[-1]
        return n * C * x.element_size() + nbytes(seg) + out_b, n * C
    if name == "segment_gather":
        return nbytes(*args) + out_b, 0
    if name == "slot_outer_segment_sum":
        vals, slot, seg, _, V = args
        n = int((seg < V).sum())
        return (n * (vals.shape[-1] * vals.element_size() + 4) + nbytes(seg)
                + out_b, n * vals.shape[-1])
    if name == "expand_rows":
        feats, key, cells = args
        n = int((key < cells).sum())
        return n * feats.shape[-1] * 4 + nbytes(key) + out_b, 0
    if name == "band_attention_delta":
        # the real tokens' rows of out and dO, the window ids; D of every
        # row written (0 on padding)
        out, _, win_id = args
        n, C = window_stats(win_id)[0], out.shape[2] * out.shape[3]
        return 2 * n * C * out.element_size() + nbytes(win_id) + out_b, \
            2 * n * C
    if name.startswith("band_attention_fused"):
        # q, k, v (and in the backward dO, the statistics and the
        # prologue's D) rows of the real tokens read once; scores and
        # values, 4 D operations per same-window pair and head forward, 10
        # D backward
        q, win_id = args[0], args[3]
        n, _, pairs, _ = window_stats(win_id)
        C = q.shape[2] * q.shape[3]
        backward = name.endswith("backward")
        in_b = (4 if backward else 3) * n * C * q.element_size() \
            + nbytes(win_id, args[4]) + (2 * n * q.shape[2] * 4 if backward
                                         else 0)
        return in_b + out_b, (10 if backward else 4) * C * pairs
    if name == "qkv_project":
        # the real tokens' rows of x and pos, the weights and window ids;
        # q, k, v written for every row (0 on padding); three products
        x, pos = args[0], args[1]
        n, C = window_stats(args[8])[0], x.shape[-1]
        in_b = n * C * (x.element_size() + pos.element_size()) \
            + nbytes(*args[2:9])
        return in_b + out_b, 6 * n * C * C
    if name == "qkv_project_backward":
        # every row of x, pos, dq, dk, dv and the weights; dx and the f32
        # parameter gradients; six products (three for dx, three weight
        # gradients)
        n, C = args[0].shape[0] * args[0].shape[1], args[0].shape[-1]
        return nbytes(*args) + out_b, 12 * n * C * C
    if name.startswith("band_attention_qkv"):
        x, pos, weights = args[0], args[1], args[2:8]
        n, _, pairs, _ = window_stats(args[8])
        C = x.shape[-1]
        rows = n * C * (x.element_size() + pos.element_size())
        in_b = rows + nbytes(*weights, args[8], args[9], *args[11:])
        backward = name.endswith("backward")
        ops = (18 if backward else 6) * n * C * C \
            + (10 if backward else 4) * C * pairs
        return in_b + out_b, ops
    x, weights, extent = args[0], args[2:12], args[12]
    n, C, Fd = int(extent.sum()), x.shape[-1], args[6].shape[1]
    in_b = 2 * n * C * x.element_size() + nbytes(*weights, extent,
                                                 *args[13:])
    ops = (6 if name.endswith("backward") else 2) * n * (C * C + 2 * C * Fd)
    return in_b + out_b, ops


def library_call(name: str, op: str, args):
    """One PyTorch call that computes the kernel's function on the same
    inputs (into a buffer made beforehand), or None where no single call
    does: K2 reduces and broadcasts back, K5 chains three products with
    two LayerNorms, K6 and K7 project inside the window attention, their
    bf16 projections and the projections' backward are three products
    each (rounded, with their biases), and
    K8 backward's D prologue wants f32 sums of bf16 products (``einsum``
    of bf16 returns bf16, so it is a product and a sum).  For
    K8: ``scaled_dot_product_attention`` over all V x V pairs under a
    boolean [B, 1, V, V] same-window-and-valid-key mask built beforehand
    (fully masked rows give NaN there, 0 in K8), and for its backward
    ``torch.autograd.grad`` through that call.  For K4 two calls, since K4
    writes the whole grid: ``zero_`` of the grid, then ``index_copy_`` of
    the occupied rows.  Timed for comparison only; the port calls none of
    them."""
    def flat(seg, V):
        B = seg.shape[0]
        return (torch.where(seg < V, seg, V).long() + (V + 1) * torch.arange(
            B, device=seg.device)[:, None]).reshape(-1)

    if name == "segment_reduce" and op == "max":
        x, seg, V, _ = args
        B, P, C = x.shape
        idx = flat(seg, V)[:, None].expand(-1, C).contiguous()
        out = torch.zeros(B * (V + 1), C, dtype=x.dtype, device=x.device)
        src = x.reshape(-1, C)
        return lambda: out.scatter_reduce_(0, idx, src, "amax",
                                           include_self=False)
    if name == "segment_gather":
        table, seg = args
        B, V, C = table.shape
        padded = torch.cat([table, table.new_zeros(B, 1, C)], 1).reshape(-1, C)
        idx = flat(seg, V)
        return lambda: torch.index_select(padded, 0, idx)
    if name == "slot_outer_segment_sum":
        vals, slot, seg, S, V = args
        B, P, cv = vals.shape
        idx = torch.where(seg < V, seg.long() * S + slot.long(), V * S) \
            + (V * S + 1) * torch.arange(B, device=seg.device)[:, None]
        out = torch.zeros(B * (V * S + 1), cv, device=vals.device)
        idx, src = idx.reshape(-1), vals.reshape(-1, cv)
        return lambda: out.index_add_(0, idx, src)
    if name.startswith("band_attention_fused"):
        import torch.nn.functional as F
        from torch.nn.attention import SDPBackend, sdpa_kernel

        q, k, v, win_id, key_valid = args[:5]
        real = win_id != 2 ** 31 - 1
        mask = ((win_id[:, :, None] == win_id[:, None, :])
                & key_valid[:, None, :] & real[:, :, None])[:, None]
        # [B, H, V, D]; the fused backends take heads of a multiple of 8
        # channels, so a head of 12 gets 4 zero channels and a head below
        # 8 8 - D (set up outside the timed call), which change neither
        # the scores under the head's own scale nor its first D output
        # columns
        D = q.shape[-1]
        pad = -D % 8
        heads = lambda t: (F.pad(t, (0, pad)) if pad else t).transpose(1, 2)
        backward = name.endswith("backward")
        qh, kh, vh = (heads(t).detach().requires_grad_(backward)
                      for t in (q, k, v))
        # the fused backends only: the unfused one would hold V x V scores
        # per head

        def sdpa():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION,
                              SDPBackend.FLASH_ATTENTION]):
                return F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, scale=D ** -0.5)

        if not backward:
            return sdpa
        out, g = sdpa(), heads(args[-1])
        return lambda: torch.autograd.grad(out, (qh, kh, vh), g,
                                           retain_graph=True)
    if name == "expand_rows":
        feats, key, cells = args
        B, V, C = feats.shape
        ok = key < cells
        idx = (key.long() + (cells + 1) * torch.arange(
            B, device=key.device)[:, None])[ok]
        out = torch.empty(B * (cells + 1), C, device=feats.device)
        src = feats[ok]
        # K4 writes the whole grid: zero it, then copy the occupied rows
        return lambda: out.zero_().index_copy_(0, idx, src)
    return None


def startup():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs the port on a CUDA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print("device (nvidia-smi name, power.limit):")
    print(smi[0])
    from geomae_tpu_torch.ops import _cuda
    nvcc = subprocess.run([_cuda.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc[-1]}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN convolutions (f32 compares are "
          "full f32)")
    path = _cuda.library_path()
    built = not path.exists()
    t = time.perf_counter()
    _cuda.library()
    print(f"kernels: {path.name} "
          f"{'built' if built else 'found'} in "
          f"{time.perf_counter() - t:.1f} s")
    from geomae_tpu_torch.data import _native
    prep = _native.library_path()
    built = not prep.exists()
    t = time.perf_counter()
    _native.library()
    print(f"point prep (host C++): {prep.name} "
          f"{'built' if built else 'found'} in "
          f"{time.perf_counter() - t:.1f} s")
    log = path.with_name(path.name + ".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Function properties for" in line or "Used" in line \
                    or "spill" in line:
                print(f"  ptxas: {line.split(':', 1)[-1].strip()}")


def kernel_inputs(cfg, batch: int, device):
    """A realistic scene and its window layouts on ``device``: one
    ``clustered_frame`` (serving, batch 1) or a training batch of
    ``clustered_scene`` samples."""
    from geomae_tpu_torch.apis import to_batch
    from geomae_tpu_torch.models.detector import extract_scene
    from geomae_tpu_torch.models.sst import prepare_shift_data
    from geomae_tpu_torch.ops.windows import make_layouts
    from geomae_tpu_torch.synthetic import clustered_frame
    from geomae_tpu_torch.train.finetune import synthetic_batch

    if batch == 1:
        raw = clustered_frame(np.random.default_rng(SEED), cfg.voxel,
                              cfg.caps.max_points)
        points, valid = to_batch(cfg, raw, device)
    else:
        b = synthetic_batch(cfg, batch, seed=SEED, device=device)
        points, valid = b["points"], b["point_valid"]
    scene = extract_scene(cfg, points, valid)
    t = scene.table
    layouts = make_layouts(t.coords, t.valid, cfg.sst, cfg.voxel)
    shift = prepare_shift_data(layouts, t.valid, cfg.sst)
    describe(f"batch {batch}", scene, valid, shift)
    return scene, shift


def describe(what: str, scene, valid, shift) -> None:
    """Points, pillars and the window histogram of the kernels' inputs."""
    t = scene.table
    print(f"{what}: {valid.sum(1).tolist()} points, pillars "
          f"{t.num_voxels.tolist()} (cap {t.valid.shape[1]}), "
          f"{(t.point2voxel < t.valid.shape[1]).sum(1).tolist()} points in "
          f"cap")
    for i, lay in enumerate(shift["layers"]):
        n, wins, pairs, hist = window_stats(lay["win_id"])
        print(f"  shift {i}: tokens {n} in {wins} windows, sum of size^2 "
              f"{pairs}; window sizes {hist}")


def pretrain_inputs(cfg, device):
    """The pretrain step's kernel inputs at batch 4: the sorted scene (for
    K3 and K4) and the encoder's window layout over the visible pillars,
    a random 30 % of them compacted into ``max_visible`` slots."""
    from geomae_tpu_torch.models.mae import (encoder_shift_data,
                                             sample_mask, visible_rows)
    from geomae_tpu_torch.ops.voxelize import build_scene_batch
    from geomae_tpu_torch.train.pretrain import synthetic_batch

    b = synthetic_batch(cfg, cfg.data.batch_size, seed=SEED, device=device)
    scene = build_scene_batch(b["points"], b["point_valid"], cfg.voxel,
                              cfg.caps.max_voxels)
    keep = sample_mask(torch.Generator(device=device).manual_seed(SEED),
                       scene.table.valid, cfg.mae.random_mask_ratio)
    vis_raw, _, vis_valid = visible_rows(keep, cfg.caps.max_visible)
    shift = encoder_shift_data(scene.table, vis_raw, vis_valid, cfg)
    describe(f"pretrain batch {cfg.data.batch_size}, the encoder's "
             f"{vis_valid.sum(1).tolist()} visible tokens of "
             f"{cfg.caps.max_visible}", scene, b["point_valid"], shift)
    return scene, shift


def phase_a(cfg, what: str, inputs, keys, results: dict,
            failures: list, errors: dict | None = None,
            timings: dict | None = None) -> None:
    """The rows ``keys`` of TOL on ``inputs`` = (scene, shift data): the
    segment and target kernels on the scene's points and pillars, the SST
    kernels on the shift data's tokens.  A train step's forward runs under
    grad (K6 then writes its statistics).  ``errors``, where given,
    collects each row's largest error by (kernel name, dtype), and
    ``timings`` its (kernel ms, plain ms, bound ms)."""
    from geomae_tpu_torch.models import mae
    from geomae_tpu_torch.ops import (attention, attention_qkv, ffn, segment,
                                      targets)
    from geomae_tpu_torch.probe import cuda_ms

    print(f"phase A: kernels against their plain versions, {what} shapes")
    dev = torch.device(DEVICE)
    scene, shift = inputs
    p2v = scene.table.point2voxel
    B, P = p2v.shape
    train = B > 1
    V = scene.table.valid.shape[1]
    C, Fd = cfg.sst.d_model, cfg.sst.dim_feedforward
    F0, F1 = cfg.vfe.feat_channels[0], cfg.vfe.feat_channels[-1]
    g = torch.Generator(device=dev).manual_seed(SEED + B)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def ties(c):
        """Payloads of a few values, so maxima tie."""
        return torch.randint(-2, 3, (B, P, c), generator=g, device=dev) * 0.5

    lay = shift["layers"][1]
    Vt = lay["win_id"].shape[1]              # tokens
    attn_w = [randn(C, C, scale=C ** -0.5) if i % 2 == 0
              else randn(C, scale=0.1) for i in range(6)]
    ffn_w = [randn(C, C, scale=0.1), randn(C, scale=0.1),
             1 + randn(C, scale=0.1), randn(C, scale=0.1),
             randn(C, Fd, scale=0.1), randn(Fd, scale=0.1),
             randn(Fd, C, scale=0.1), randn(C, scale=0.1),
             1 + randn(C, scale=0.1), randn(C, scale=0.1)]
    x_tok, a_tok, d_tok = randn(B, Vt, C), randn(B, Vt, C), randn(B, Vt, C)
    xyz = torch.where(scene.valid[..., None], scene.points[..., :3], 0.0)
    if any(k[0] in ("slot_outer_segment_sum", "expand_rows") for k in keys):
        # the targets' inputs: centred (z, y, x, 1) point rows, then each
        # pillar's moment row and BEV cell
        mu, vals4 = mae._centered_vals4(scene, V)
        S = cfg.voxel.num_slots_low
        sums = targets.slot_outer_segment_sum_plain(vals4, scene.slot_sort,
                                                    p2v, S, V)
        feats13, key13 = mae._moment_feats(scene.table, cfg.voxel, sums, mu)
        cells = cfg.voxel.grid_size[0] * cfg.voxel.grid_size[1]

    def case(name, op, dt):
        """(kernel, plain version, arguments) of one row."""
        qkv = (x_tok.to(dt), lay["pos_sorted"], *attn_w, lay["win_id"],
               lay["key_valid_sorted"], cfg.sst.nhead)
        block = (x_tok.to(dt), a_tok.to(dt), *ffn_w, lay["extent"])
        if name.startswith(("band_attention_fused", "band_attention_delta")):
            # K8 on q, k, v projected from K6's inputs, as the band route
            # projects them
            xp = qkv[0] + qkv[1].to(dt)
            heads = (B, Vt, cfg.sst.nhead, C // cfg.sst.nhead)
            q, k, v = (ffn.dense(t, w, b).reshape(heads) for t, w, b in zip(
                (xp, xp, qkv[0]), attn_w[0::2], attn_w[1::2]))
            band = (q, k, v, lay["win_id"], lay["key_valid_sorted"])
            g_out = d_tok.to(dt).reshape(heads)
            if name == "band_attention_delta":
                out = attention._forward(*band, stats=False)[0]
                return (attention.band_attention_delta,
                        attention.band_attention_delta_plain,
                        (out, g_out, lay["win_id"]))
            if name.endswith("backward"):
                # the kernel alone, after its prologue (a row of its own)
                out, lse = attention._forward(*band, stats=True)
                delta = attention.band_attention_delta(out, g_out,
                                                       lay["win_id"])
                return (lambda *a: attention._backward(*a[:5], a[6], delta,
                                                       a[7]),
                        lambda *a: attention.band_attention_backward_plain(
                            *a[:-2], a[-1]),
                        (*band, out, lse, g_out))
            if not train:
                return (attention.band_attention_fused,
                        attention.band_attention, band)
            return (lambda *a: attention._forward(*a, stats=True),
                    lambda *a: (attention.band_attention(*a),
                                attention.band_attention_lse_plain(
                                    a[0], a[1], a[3], a[4])), band)
        if name == "segment_reduce":
            return (segment.segment_reduce, segment.segment_reduce_plain,
                    (randn(B, P, F1).to(dt), p2v, V, op))
        if name == "segment_broadcast":
            x = xyz.contiguous() if op == "mean" else randn(B, P, F0)
            return (segment.segment_broadcast,
                    segment.segment_broadcast_plain, (x.to(dt), p2v, V, op))
        if name == "segment_gather":
            return (segment.segment_gather, segment.segment_gather_plain,
                    (randn(B, V, 2 * C).to(dt), p2v))
        if name == "slot_outer_segment_sum":
            return (targets.slot_outer_segment_sum,
                    targets.slot_outer_segment_sum_plain,
                    (vals4, scene.slot_sort, p2v, S, V))
        if name == "expand_rows":
            return (targets.expand_rows, targets.expand_rows_plain,
                    (feats13, key13, cells))
        if name == "segment_reduce_backward":
            x = ties(F1).to(dt)
            return (segment.segment_reduce_backward,
                    segment.segment_reduce_backward_plain,
                    (x, p2v, V, op, segment.segment_reduce(x, p2v, V, op),
                     randn(B, V, F1)))
        if name == "segment_broadcast_backward":
            x = ties(F0).to(dt)
            return (segment.segment_broadcast_backward,
                    segment.segment_broadcast_backward_plain,
                    (x, p2v, V, op, segment.segment_broadcast(x, p2v, V, op),
                     randn(B, P, F0).to(dt)))
        if name == "post_attention_block":
            return ffn.post_attention_block, ffn.post_attention_block_plain, \
                block
        if name == "post_attention_block_backward":
            return (ffn.post_attention_block_backward,
                    ffn.post_attention_block_backward_plain,
                    (*block, d_tok.to(dt)))
        if name == "qkv_project":
            return (attention_qkv.qkv_project,
                    attention_qkv.qkv_project_plain, qkv[:9])
        if name == "qkv_project_backward":
            # the cotangents K8's backward gives K7's projections' backward
            heads = (B, Vt, cfg.sst.nhead, C // cfg.sst.nhead)
            q, k, v = (t.view(heads) for t in attention_qkv.qkv_project(
                *qkv[:9]))
            band = (q, k, v, lay["win_id"], lay["key_valid_sorted"])
            out, lse = attention._forward(*band, stats=True)
            ds = attention.band_attention_fused_backward(
                *band, out, lse, d_tok.to(dt).view(heads))
            return (attention_qkv.qkv_project_backward,
                    attention_qkv.qkv_project_backward_plain,
                    (*qkv[:2], *attn_w[0::2],
                     *[d.reshape(B, Vt, C) for d in ds]))
        if name == "band_attention_qkv" and not train:
            return (attention_qkv.band_attention_qkv,
                    attention_qkv.band_attention_qkv_plain, qkv)
        if name == "band_attention_qkv":
            return (lambda *a: attention_qkv._forward(*a, stats=True),
                    lambda *a: (attention_qkv.band_attention_qkv_plain(*a),
                                attention_qkv.band_attention_qkv_lse_plain(
                                    *a)), qkv)
        out, lse = attention_qkv._forward(*qkv, stats=True)
        return (attention_qkv.band_attention_qkv_backward,
                lambda *a: attention_qkv.band_attention_qkv_backward_plain(
                    *a[:-2], a[-1]), (*qkv, out, lse, d_tok.to(dt)))

    if any(k[0].startswith("segment_") for k in keys):
        from geomae_tpu_torch.probe_segment import pillar_histogram
        hist, top = pillar_histogram(p2v, V)
        print(f"  points per pillar in the cap (K1's and K2's segments): "
              f"{hist}; largest pillar {top} points")
    for key in keys:
        name, op = key
        for dt, tol in TOL[key].items():
            kern, plain, args = case(name, op, dt)
            label = (f"{name}{'(' + op + ')' if op else ''} {str(dt)[6:]} "
                     f"{tuple(args[0].shape)}")
            got, kern_first_ms = once_ms(lambda: kern(*args))
            want, first_ms = once_ms(lambda: plain(*args))
            err = check(label, name, got, want, dt, tol, failures, args)
            if errors is not None:
                errors[name, dt] = max(errors.get((name, dt), 0.0), err)
            if name in DETERMINISTIC:
                again = kern(*args)
                same = all(torch.equal(a, b) for a, b in zip(
                    got if isinstance(got, tuple) else (got,),
                    again if isinstance(again, tuple) else (again,)))
                print(f"    two launches bitwise equal: {same}")
                if not same:
                    failures.append(f"{label}: two launches differ")
            long_kern = kern_first_ms >= LONG_KERNEL_MS
            ms = kern_first_ms if long_kern else cuda_ms(lambda: kern(*args))
            # a call of HOST_PACED_MS or more outlasts its enqueue: not
            # timed at the host's pace
            host = f"{cuda_ms(lambda: kern(*args), spin=False):.4f} ms" \
                if ms < HOST_PACED_MS else "not timed"
            plain_ms = first_ms if first_ms >= LONG_CALL_MS else cuda_ms(
                lambda: plain(*args), iters=3 if train else 5, warmup=1)
            print(f"    kernel {ms:.4f} ms" + (" (one call)" if long_kern
                                                 else "")
                  + f" (host-paced {host}), plain {plain_ms:.4f} ms"
                  + (" (one call)" if first_ms >= LONG_CALL_MS else ""))
            if key not in PATH_DTYPE:     # a row the kernels line omits
                continue
            nb, ops = work(name, args, got)
            t_bytes = nb / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dt] * 1e3
            bound = (f"bound {max(t_bytes, t_ops):.4f} ms: {nb / 1e6:.1f} MB "
                     f"({t_bytes:.4f} ms), {ops / 1e9:.3f} GFLOP "
                     f"({t_ops:.4f} ms)")
            if timings is not None:
                timings[name, dt] = (ms, plain_ms, max(t_bytes, t_ops))
            if PATH_DTYPE[key] != dt or (not train and name in NOT_SERVED):
                print(f"    {bound}")
                continue
            lib = library_call(name, op, args)
            lib_ms = lib_host = None
            if lib is not None:
                lib_ms = once_ms(lib)[1]
                if lib_ms < LONG_CALL_MS:
                    lib_ms = cuda_ms(lib, iters=5, warmup=1)
                    host_ms = cuda_ms(lib, iters=5, warmup=1, spin=False)
                    lib_host = f"{host_ms:.4f} ms"
                else:
                    lib_host = "not timed; one call"
            print("    library call " + ("none" if lib is None else
                                         f"{lib_ms:.4f} ms (host-paced "
                                         f"{lib_host})") + f"; {bound}")
            results.setdefault(name, []).append(
                (err, ms, plain_ms, t_bytes, t_ops, lib_ms))


def once_ms(fn):
    """(fn's result, the ms of that one call), CUDA events around it."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def reset_counts():
    from geomae_tpu_torch.ops import (attention, attention_qkv, ffn, segment,
                                      targets)
    fns = {"slot_outer_segment_sum": targets.slot_outer_segment_sum,
           "expand_rows": targets.expand_rows,
           "segment_reduce": segment.segment_reduce,
           "segment_broadcast": segment.segment_broadcast,
           "segment_gather": segment.segment_gather,
           "band_attention_qkv": attention_qkv.band_attention_qkv,
           "band_attention_qkv_backward":
               attention_qkv.band_attention_qkv_backward,
           "post_attention_block": ffn.post_attention_block,
           "post_attention_block_backward":
               ffn.post_attention_block_backward,
           "band_attention_fused": attention.band_attention_fused,
           "band_attention_fused_backward":
               attention.band_attention_fused_backward,
           "band_attention_delta": attention.band_attention_delta,
           "qkv_project": attention_qkv.qkv_project,
           "qkv_project_backward": attention_qkv.qkv_project_backward}
    for fn in fns.values():
        fn.launches = 0
    attention_qkv.band_attention_qkv.stats = 0
    attention.band_attention_fused.stats = 0
    return fns


def check_launches(fns, per: dict, n: int, what: str,
                   failures: list) -> dict:
    """The launches since reset_counts against ``per`` x ``n``."""
    launches = {k: fn.launches for k, fn in fns.items()}
    stats = {k: fns[k].stats for k in ("band_attention_qkv",
                                       "band_attention_fused")}
    print(f"  launches in {n} {what}: {launches}; K6 and K8 with "
          f"statistics: {list(stats.values())}")
    for k, count in per.items():
        if launches[k] != count * n:
            failures.append(f"{k} launched {launches[k]} times in {n} "
                            f"{what}, expected {count * n}")
    for k, wrote in stats.items():     # statistics under grad only
        if wrote != (launches[k] if per[k + "_backward"] else 0):
            failures.append(f"{k} wrote statistics {wrote} times in {what}")
    return launches


def phase_b(cfg, failures: list) -> dict:
    from geomae_tpu_torch.apis import inference_detector, init_model
    from geomae_tpu_torch.profile_serving import host_ms, stage_ms
    from geomae_tpu_torch.synthetic import clustered_frame

    print(f"phase B: {FRAMES} frames through inference_detector, "
          f"{cfg.compute_dtype}, full width, attention route "
          f"{cfg.sst.attention_impl}")
    det = init_model(cfg=cfg, device=DEVICE,
                     generator=torch.Generator().manual_seed(SEED))
    frames = [clustered_frame(np.random.default_rng(SEED + 1 + f),
                              cfg.voxel, cfg.caps.max_points)
              for f in range(FRAMES)]
    torch.cuda.reset_peak_memory_stats()
    fns = reset_counts()
    outs = []
    for f, raw in enumerate(frames):
        res, ms = host_ms(lambda: inference_detector(det, raw))
        outs.append(res)
        print(f"  frame {f}: {len(raw)} points -> {len(res['scores'])} "
              f"detections in {ms:.1f} ms")
    launches = check_launches(fns, on_route(PER_FRAME, cfg), FRAMES, "frames",
                              failures)
    for res in outs:
        n = len(res["scores"])
        ok = (res["boxes"].shape == (n, 9)
              and np.isfinite(res["boxes"]).all()
              and ((res["scores"] > 0) & (res["scores"] <= 1)).all()
              and ((res["labels"] >= 0)
                   & (res["labels"] < cfg.head.num_classes)).all())
        if not ok or n == 0:
            failures.append(f"frame detections malformed ({n} boxes)")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    stages = stage_ms(det, frames[-1])
    print("  stages of one more frame (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items()))
    return launches


def phase_c(cfg, failures: list):
    from geomae_tpu_torch.apis import Detector3D, replace, to_batch
    from geomae_tpu_torch.models.detector import extract_scene
    from geomae_tpu_torch.synthetic import clustered_frame

    cfg32 = replace(cfg, compute_dtype="float32")
    print(f"phase C: one frame in float32, GPU kernels against CPU plain "
          f"versions, same seeded weights, {cfg.head_type} head")
    raw = clustered_frame(np.random.default_rng(SEED + 1), cfg.voxel,
                          cfg.caps.max_points)
    got = {}
    for dev in (DEVICE, "cpu"):
        det = Detector3D(cfg32, device=dev,
                         generator=torch.Generator().manual_seed(SEED))
        seen = []
        hooks = [m.register_forward_hook(lambda m, i, o: seen.append(o))
                 for m in (det.model.backbone.encoder_blocks, det.model.neck)]
        t = time.perf_counter()
        with torch.no_grad():
            scene = extract_scene(cfg32, *to_batch(cfg32, raw, dev))
            out = det.model(scene)
        if dev != "cpu":
            torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        print(f"  {dev}: {(time.perf_counter() - t):.1f} s")
        got[dev] = (scene, *seen, out)
    (sg, xg, fg, og), (sc, xc, fc, oc) = got[DEVICE], got["cpu"]
    differ = [f for f in ("coords", "valid", "num_voxels", "point2voxel")
              if not torch.equal(getattr(sg.table, f).cpu(),
                                 getattr(sc.table, f))]
    print(f"  voxel table: {differ or 'bitwise equal'}")
    failures += [f"voxel table {f} differs" for f in differ]
    valid = sc.table.valid
    compare("SST output (valid rows)", xg.cpu()[valid], xc[valid],
            *PARITY_TOL, failures)
    compare(f"FPN output {tuple(fc.shape)}, max |x| "
            f"{float(fc.abs().max()):.3e}", fg.cpu(), fc, *PARITY_TOL,
            failures)
    for name, a, b in zip(head_names(og), head_maps(og), head_maps(oc)):
        compare(f"head {name} {tuple(b.shape)}, std {float(b.std()):.3e}",
                a.cpu(), b, *PARITY_TOL, failures)
    return og, oc


def head_names(out) -> list:
    """The names of a head's outputs: the anchor head's fields, or one per
    CenterHead task (its six maps)."""
    if isinstance(out, list):
        return [f"task{i} ({', '.join(d)})" for i, d in enumerate(out)]
    return list(out._fields)


def head_maps(out) -> list:
    """A head's outputs, each CenterHead task's maps flattened into one."""
    if isinstance(out, list):
        return [torch.cat([t.flatten() for t in d.values()]) for d in out]
    return list(out)


def phase_d(cfg, failures: list, repeat: int = REPEAT) -> dict:
    from geomae_tpu_torch.profile_serving import host_ms
    from geomae_tpu_torch.train.finetune import (init_state, make_train_step,
                                                 synthetic_batch)

    bz = cfg.data.batch_size
    print(f"phase D: fine-tune train steps, {cfg.compute_dtype}, batch {bz}, "
          f"full width, attention route {cfg.sst.attention_impl}: {DISTINCT} "
          f"batches, then {repeat} more steps on the last")
    state = init_state(cfg, DEVICE, torch.Generator().manual_seed(SEED))
    step = make_train_step(cfg)
    before = [p.detach().clone() for p in state.model.parameters()]
    batches = [synthetic_batch(cfg, bz, seed=SEED + 10 + i, device=DEVICE)
               for i in range(DISTINCT)]
    n = DISTINCT + repeat
    torch.cuda.reset_peak_memory_stats()
    fns = reset_counts()
    times, losses = [], []
    for i in range(n):
        batch = batches[min(i, DISTINCT - 1)]
        (_, l), ms = host_ms(lambda: step(state, batch))
        losses.append({k: float(v) for k, v in l.items()})
        times.append(ms)
        print(f"  step {i}: {ms:.1f} ms, " + ", ".join(
            f"{k} {v:.4f}" for k, v in losses[-1].items()))
    launches = check_launches(fns, on_route(PER_STEP, cfg), n, "train steps",
                              failures)
    if not all(np.isfinite(v) for l in losses for v in l.values()):
        failures.append("a train step's losses are not finite")
    moved = [not torch.equal(a, p.detach())
             for a, p in zip(before, state.model.parameters())]
    print(f"  parameters changed: {sum(moved)} of {len(moved)} tensors")
    if not all(moved):
        failures.append("some parameters did not change")
    rep = [l["loss"] for l in losses[DISTINCT - 1:]]
    print(f"  loss on the repeated batch: {rep[0]:.4f} -> {rep[-1]:.4f} over "
          f"{len(rep) - 1} steps")
    if not rep[-1] < rep[0]:
        failures.append("the loss did not fall on the repeated batch")
    print(f"  step time median {float(np.median(times[1:])):.1f} ms over "
          f"{n - 1} steps after the first ({times[0]:.1f} ms); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return launches


def phase_e(cfg, failures: list) -> None:
    from geomae_tpu_torch.apis import replace
    from geomae_tpu_torch.train.finetune import (init_state, make_train_step,
                                                 synthetic_batch)

    cfg32 = replace(cfg, compute_dtype="float32")
    print(f"phase E: one float32 train step (batch 1), GPU kernels against "
          f"CPU plain versions, same seeded weights and batch, "
          f"{cfg.head_type} head")
    batch = synthetic_batch(cfg32, 1, seed=SEED + 50, device="cpu")
    got = {}
    for dev in (DEVICE, "cpu"):
        t = time.perf_counter()
        state = init_state(cfg32, dev, torch.Generator().manual_seed(SEED))
        step = make_train_step(cfg32)
        old = {k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()}
        losses = step.loss_fn(state.model,
                              {k: v.to(dev) for k, v in batch.items()})
        losses["loss"].backward()
        grads = {k: p.grad.detach().cpu().clone()
                 for k, p in state.model.named_parameters()}
        state.tx.step()
        new = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        got[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                    grads, old, new, state.tx.lr(0))
        print(f"  {dev}: {time.perf_counter() - t:.1f} s, losses "
              f"{got[dev][0]}")
    compare_step(got[DEVICE], got["cpu"], STEP_TOL, failures)


def compare_step(gpu, cpu, tol: dict, failures: list) -> None:
    """One train step on the GPU against the same step on the CPU:
    (losses, gradients, state before, state after, lr) of each."""
    (lg, gg, og, ng, lr), (lc, gc, oc, nc, _) = gpu, cpu
    for k in lc:
        rel = abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-12)
        if rel > tol["loss"]:
            failures.append(f"loss {k}: GPU {lg[k]} CPU {lc[k]}")
    rel = {k: float((gg[k] - gc[k]).norm() / gc[k].norm().clamp_min(1e-30))
           for k in gc}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    print(f"  gradients: worst relative norm errors {worst} (bound "
          f"{tol['grad']:g}, {len(rel)} parameters)")
    failures += [f"gradient {k}: {e:.2e}" for k, e in rel.items()
                 if not e <= tol["grad"]]
    sel_tol, rel_g, any_tol = tol["update"]
    eps = torch.finfo(torch.float32).eps
    upd_worst, stat_worst, n_sel, n_all, n_flip = 0.0, 0.0, 0, 0, 0
    for k in nc:
        if k.endswith("num_batches_tracked"):
            if not int(ng[k]) == int(nc[k]) == 1:
                failures.append(f"{k}: {int(ng[k])}, {int(nc[k])}")
        elif "running_" in k:
            a, s2 = tol["stats"]
            d = (ng[k] - nc[k]).abs()
            stat_worst = max(stat_worst, float(d.max()))
            if bool((d > a + s2 * nc[k].abs()).any()):
                failures.append(f"batch statistic {k}")
        else:
            d = ((ng[k] - og[k]) - (nc[k] - oc[k])).abs() / lr
            d = d - tol["ulps"] * eps * oc[k].abs() / lr
            big = gc[k].abs() > rel_g * gc[k].square().mean().sqrt()
            sel = big & (gg[k].sign() == gc[k].sign())
            n_sel, n_all = n_sel + int(sel.sum()), n_all + sel.numel()
            n_flip += int(big.sum() - sel.sum())
            upd_worst = max(upd_worst, float(d[sel].max()) if sel.any()
                            else 0.0)
            if bool((d[sel] > sel_tol).any()) or bool((d > any_tol).any()):
                failures.append(f"updated parameter {k}")
    ulps = f", beyond {tol['ulps']} f32 ulps of the weight" if tol["ulps"] \
        else ""
    print(f"  updates: worst difference {upd_worst:.3e} lr{ulps} on the "
          f"{n_sel} of {n_all} elements where |g| > {rel_g:g} of its "
          f"tensor's rms and the signs agree ({n_flip} more where they "
          f"differ; bound {sel_tol:g} lr; elsewhere {any_tol:g} lr); batch "
          f"statistics: worst abs difference {stat_worst:.3e}")


def phase_f(cfg, failures: list, repeat: int = REPEAT) -> dict:
    from geomae_tpu_torch.profile_serving import host_ms
    from geomae_tpu_torch.train.pretrain import (init_state, make_train_step,
                                                 synthetic_batch)

    bz = cfg.data.batch_size
    print(f"phase F: pretrain steps, {cfg.compute_dtype}, batch {bz}, full "
          f"width, attention route {cfg.sst.attention_impl}: {DISTINCT} "
          f"batches, then {repeat} more steps on the last with the same mask")
    state = init_state(cfg, DEVICE, torch.Generator().manual_seed(SEED))
    step = make_train_step(cfg)
    names = [k for k, _ in state.model.named_parameters()]
    before = [p.detach().clone() for p in state.model.parameters()]
    batches = [synthetic_batch(cfg, bz, seed=SEED + 20 + i, device=DEVICE)
               for i in range(DISTINCT)]
    n = DISTINCT + repeat
    torch.cuda.reset_peak_memory_stats()
    fns = reset_counts()
    times, losses = [], []
    for i in range(n):
        batch = batches[min(i, DISTINCT - 1)]
        # the mask generator, seeded alike on every step of the repeat
        gen = torch.Generator(device=DEVICE).manual_seed(
            SEED + min(i, DISTINCT - 1))
        (_, l), ms = host_ms(lambda: step(state, batch, gen))
        losses.append({k: float(v) for k, v in l.items()})
        times.append(ms)
        print(f"  step {i}: {ms:.1f} ms, " + ", ".join(
            f"{k} {v:.4f}" for k, v in losses[-1].items()))
    launches = check_launches(fns, on_route(per_pretrain_step(cfg), cfg), n,
                              "pretrain steps", failures)
    if not all(len(l) == 7 and all(np.isfinite(v) for v in l.values())
               for l in losses):
        failures.append("a pretrain step's seven losses are not all finite")
    still = [k for k, a, p in zip(names, before, state.model.parameters())
             if torch.equal(a, p.detach())]
    print(f"  parameters changed: {len(names) - len(still)} of {len(names)} "
          f"tensors (mask_token and the six heads among them)")
    if still:
        failures.append(f"parameters did not change: {still[:5]}")
    rep = [l["loss"] for l in losses[DISTINCT - 1:]]
    print(f"  loss on the repeated batch and mask: {rep[0]:.4f} -> "
          f"{rep[-1]:.4f} over {len(rep) - 1} steps")
    if not rep[-1] < rep[0]:
        failures.append("the pretrain loss did not fall on the repeated "
                        "batch")
    print(f"  step time median {float(np.median(times[1:])):.1f} ms over "
          f"{n - 1} steps after the first ({times[0]:.1f} ms); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return launches


def compare_targets(tg, tc, valid, cfg, failures: list) -> None:
    """Phase G's targets: GPU (K3, K4) against CPU (plain versions) on the
    pillar rows ``valid``."""
    voxel = cfg.voxel
    for name in ("low_occ", "med_occ"):
        same = torch.equal(getattr(tg, name).cpu(), getattr(tc, name))
        print(f"  {name}: {'equal' if same else 'DIFFERENT'} "
              f"({int(getattr(tc, name).sum())} occupied)")
        if not same:
            failures.append(f"target {name} differs")
    # sub-voxel edges (z, y, x) in metres of each level
    vx, vy, vz = voxel.voxel_size
    for name, ratio in (("low_tgt", voxel.sub_voxel_ratio_low),
                        ("med_tgt", voxel.sub_voxel_ratio_med),
                        ("centroid_top", (1, 1, 1))):
        edge = torch.tensor([vz / ratio[0], vy / ratio[1], vx / ratio[2]])
        compare(f"{name} in metres", getattr(tg, name).cpu() * edge,
                getattr(tc, name) * edge, CENTROID_TOL_M, 0.0, failures)
    cv = tc.curv
    apart = valid & (cv[..., 1] - cv[..., 2] > 1e-2 * cv[..., 0])
    cos = (tg.normal.cpu() * tc.normal).sum(-1)
    miss = int((1 - cos[apart].abs() > NORMAL_TOL).sum())
    print(f"  normals: {int(apart.sum())} of {int(valid.sum())} pillars with "
          f"separated small eigenvalues; worst 1 - |cos| there "
          f"{float((1 - cos[apart].abs()).max()):.3e} (bound {NORMAL_TOL:g}, "
          f"{miss} over); sign flipped on {int((cos[apart] < 0).sum())} of "
          f"them and on {int((cos[valid & ~apart] < 0).sum())} of the "
          f"{int((valid & ~apart).sum())} others")
    if miss or not apart.any():
        failures.append("normals differ between the devices")


def phase_g(cfg, failures: list) -> None:
    from geomae_tpu_torch.config import replace
    from geomae_tpu_torch.models.mae import (GeoMAETargets, pretrain_loss,
                                             sample_mask)
    from geomae_tpu_torch.ops.voxelize import build_scene_batch
    from geomae_tpu_torch.train.pretrain import (init_state, synthetic_batch,
                                                 targets_and_mask)

    cfg32 = replace(cfg, compute_dtype="float32")
    print("phase G: one float32 pretrain step (batch 1), GPU kernels against "
          "CPU plain versions, same seeded weights, batch and mask")
    batch = synthetic_batch(cfg32, 1, seed=SEED + 60, device="cpu")
    # a CUDA and a CPU generator draw different numbers: one keep for both
    keep = sample_mask(torch.Generator().manual_seed(SEED),
                       build_scene_batch(batch["points"], batch["point_valid"],
                                         cfg32.voxel,
                                         cfg32.caps.max_voxels).table.valid,
                       cfg32.mae.random_mask_ratio)
    scenes, own = {}, {}
    for dev in (DEVICE, "cpu"):
        scenes[dev], own[dev], _ = targets_and_mask(
            cfg32, {k: v.to(dev) for k, v in batch.items()},
            keep=keep.to(dev))
    compare_targets(own[DEVICE], own["cpu"], scenes["cpu"].table.valid, cfg32,
                    failures)
    # the step on both devices learns the CPU's targets, so that it holds
    # the model and its kernels; each device's own targets give its loss
    # beside, where a flipped normal moves loss_curv_around
    got, own_losses = {}, {}
    for dev in (DEVICE, "cpu"):
        t = time.perf_counter()
        state = init_state(cfg32, dev, torch.Generator().manual_seed(SEED))
        old = {k: v.detach().cpu().clone()
               for k, v in state.model.state_dict().items()}
        kd = keep.to(dev)
        preds = state.model(scenes[dev], kd)
        losses = pretrain_loss(preds, GeoMAETargets(
            *[a.to(dev) for a in own["cpu"]]), scenes[dev], kd, cfg32)
        with torch.no_grad():
            own_losses[dev] = {k: float(v) for k, v in pretrain_loss(
                preds, own[dev], scenes[dev], kd, cfg32).items()}
        losses["loss"].backward()
        grads = {k: p.grad.detach().cpu().clone()
                 for k, p in state.model.named_parameters()}
        state.tx.step()
        new = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
        got[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                    grads, old, new, state.tx.lr(0))
        print(f"  {dev}: {time.perf_counter() - t:.1f} s, losses "
              f"{got[dev][0]}")
    compare_step(got[DEVICE], got["cpu"], PRETRAIN_STEP_TOL, failures)
    rel = {k: abs(own_losses[DEVICE][k] - v) / max(abs(v), 1e-12)
           for k, v in own_losses["cpu"].items()}
    print(f"  losses on each device's own targets, relative difference: "
          f"{rel}")
    failures += [f"own-target loss {k}: {e:.2e}" for k, e in rel.items()
                 if k not in ("loss_curv_around", "loss")
                 and not e <= PRETRAIN_STEP_TOL["loss"]]


def sst_width(cfg, C: int, heads: int, Fd: int):
    """``cfg`` with its SST at d_model C in ``heads`` heads, FFN Fd."""
    from geomae_tpu_torch.config import apply_overrides

    return apply_overrides(cfg, [f"sst.d_model={C}", f"sst.nhead={heads}",
                                 f"sst.dim_feedforward={Fd}"])


def phase_widths(pcfg, failures: list) -> list:
    """Phase A's K8, K6, K7 and projection rows at every width they take
    (C of 128, 256, 384, 512, 640, 768 and 1024 in heads of 8, 16, 32, 64
    and 128, C 128 to 512 in heads of 1, 2 and 4, C 384 in heads of 3, 6,
    12, 24, 48, 96 and 192, C 256 and 512 in heads of 256, C 384 and 512
    in one head) and its K5 rows at
    every (C, F) K5 takes, on the pretrain encoder's visible tokens at
    batch 4 (positions of C channels); then K1 and K2 as the wide VFE (64,
    256) calls them.  Returns one summary a row: the bf16 call's time,
    bound and library call, the largest error of each dtype and of
    both, and each dtype's kernel, plain and bound ms."""
    from geomae_tpu_torch.config import apply_overrides
    from geomae_tpu_torch.ops import attention, attention_qkv, ffn

    dev = torch.device(DEVICE)
    rows = []

    def run(cfg, what, inputs, keys, width):
        res, errors, timings = {}, {}, {}
        phase_a(cfg, what, inputs, keys, res, failures, errors, timings)
        for name, ((err, ms, plain_ms, tb, to, lib),) in res.items():
            by_dtype = {str(dt)[6:]: e for (n, dt), e in errors.items()
                        if n == name}
            rows.append(dict(name=name, width=width, ms=ms,
                             plain_ms=plain_ms, bound_ms=max(tb, to),
                             bound_by="bytes" if tb >= to else "operations",
                             library_ms=lib,
                             max_abs_err=max([err, *by_dtype.values()]),
                             max_abs_err_by_dtype=by_dtype,
                             ms_by_dtype={str(dt)[6:]: t for (n, dt), t
                                          in timings.items() if n == name}))

    for C in attention.KERNEL_CHANNELS:
        cfg = apply_overrides(pcfg, [f"sst.d_model={C}"])
        inputs = pretrain_inputs(cfg, dev)
        for D in (d for c, d in attention.kernel_widths() if c == C):
            assert attention_qkv.kernel_takes(C, C // D), (C, D)
            run(sst_width(cfg, C, C // D, 2 * C),
                f"K8, K6, K7 and the projections at C {C} in heads of {D}",
                inputs, K8 + QKV, f"C {C}, D {D}")
        for Fd in sorted(f for c, f in ffn.KERNEL_WIDTHS if c == C):
            run(sst_width(cfg, C, 8, Fd), f"K5 at (C, F) ({C}, {Fd})",
                inputs, K5, f"C {C}, F {Fd}")
        del inputs
    wide = apply_overrides(pcfg, WIDE_OPTIONS)
    run(wide, "K1 and K2 in the wide VFE (64, 256)", pretrain_inputs(wide, dev),
        [("segment_reduce", "max"), ("segment_broadcast", "max")],
        "VFE (64, 256)")
    print("  widths (bf16 ms / bound ms / library ms; plain ms; largest "
          "error against the plain version by dtype; kernel / bound / "
          "plain ms by dtype):")
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        errs = ", ".join(f"{k} {v:.3e}"
                         for k, v in r["max_abs_err_by_dtype"].items())
        times = ", ".join(f"{k} {m:.4f} / {b:.4f} / {p:.4f}"
                          for k, (m, p, b) in r["ms_by_dtype"].items())
        print(f"    {r['name']} at {r['width']}: {r['ms']:.4f} / "
              f"{r['bound_ms']:.4f} ({r['bound_by']}) / {lib}; plain "
              f"{r['plain_ms']:.4f}; error {errs}; {times}")
    return rows


def train_and_serve(wp, wf, what: str, failures: list) -> dict:
    """``N_STEPS`` bf16 pretrain steps of ``wp`` at its batch size (seven
    finite loss terms, each kernel's launches a step, every parameter
    moved) and one served frame of ``wf``, with no call of the plain
    ``band_attention`` and none of the unfused FFN chain: K5 launches once
    a layer.  Returns the launches of the steps and the frame."""
    from geomae_tpu_torch.apis import inference_detector, init_model
    from geomae_tpu_torch.profile_serving import host_ms
    from geomae_tpu_torch.synthetic import clustered_frame
    from geomae_tpu_torch.train.pretrain import (init_state, make_train_step,
                                                 synthetic_batch)

    bz = wp.data.batch_size
    with plain_attention_calls() as plain, unfused_ffn_calls() as unfused:
        state = init_state(wp, DEVICE, torch.Generator().manual_seed(SEED))
        step = make_train_step(wp)
        names = [k for k, _ in state.model.named_parameters()]
        before = [p.detach().clone() for p in state.model.parameters()]
        batches = [synthetic_batch(wp, bz, seed=SEED + 95 + i, device=DEVICE)
                   for i in range(N_STEPS)]
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        fns = reset_counts()
        for i, batch in enumerate(batches):
            (_, l), ms = host_ms(lambda: step(state, batch, gen))
            losses = {k: float(v) for k, v in l.items()}
            print(f"  step {i}: {ms:.1f} ms, loss {losses['loss']:.4f}")
            if not (len(losses) == 7 and all(
                    np.isfinite(v) for v in losses.values())):
                failures.append(f"{what}: step {i}'s seven losses are not "
                                "all finite")
        runs = check_launches(fns, on_route(per_pretrain_step(wp), wp),
                              N_STEPS, f"pretrain steps ({what})", failures)
        still = [k for k, a, p in zip(names, before, state.model.parameters())
                 if torch.equal(a, p.detach())]
        print(f"  parameters changed: {len(names) - len(still)} of "
              f"{len(names)} tensors")
        if still:
            failures.append(f"{what}: parameters did not change: "
                            f"{still[:5]}")
        del state, batches, before
        det = init_model(cfg=wf, device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED))
        raw = clustered_frame(np.random.default_rng(SEED + 97), wf.voxel,
                              wf.caps.max_points)
        fns = reset_counts()
        res, ms = host_ms(lambda: inference_detector(det, raw))
        n = len(res["scores"])
        print(f"  frame: {len(raw)} points -> {n} detections in {ms:.1f} ms")
        if not (n and np.isfinite(res["boxes"]).all()):
            failures.append(f"{what}: frame malformed ({n} boxes)")
        served = check_launches(fns, on_route(PER_FRAME, wf), 1,
                                f"frame ({what})", failures)
        del det
    print(f"  calls of the plain band_attention: {len(plain)}; of the "
          f"unfused FFN chain: {len(unfused)}")
    if plain:
        failures.append(f"{what} called the plain band_attention "
                        f"{len(plain)} times")
    if unfused:
        failures.append(f"{what} ran the unfused FFN chain {len(unfused)} "
                        "times")
    return {k: runs[k] + served[k] for k in runs}


def add_launches(total: dict, runs: dict) -> None:
    for k in runs:
        total[k] = total.get(k, 0) + runs[k]


def phase_n(pcfg, cfg, failures: list) -> dict:
    """The shipped d_model 128 in 16 heads of 8 and in one head of 128
    (``sst.nhead``), on the ``band`` route (K8) and on the ``qkv`` route
    (K6 and K7), with K5: per head count and route, ``train_and_serve``;
    at 16 heads phase G (one f32 pretrain step on the card against the
    CPU) at phase M's small caps.  Returns the launches of the steps and
    frames."""
    from geomae_tpu_torch.config import apply_overrides

    total: dict = {}
    for heads in N_HEADS:
        D = pcfg.sst.d_model // heads
        for route in (BAND_OPTION, QKV_OPTION):
            opts = [f"sst.nhead={heads}", route]
            wp, wf = (apply_overrides(c, opts) for c in (pcfg, cfg))
            what = f"{heads} head{'s' * (heads > 1)} of {D}, {route}"
            print(f"phase N: d_model {wp.sst.d_model} in {what}: {N_STEPS} "
                  f"bf16 pretrain steps at batch {wp.data.batch_size}, one "
                  "served frame")
            add_launches(total, train_and_serve(wp, wf, what, failures))
    phase_g(apply_overrides(pcfg, M_SMALL_CAPS + [f"sst.nhead={N_HEADS[0]}"]),
            failures)
    return total


def phase_o(pcfg, cfg, failures: list) -> dict:
    """The shipped d_model 128 with FFN widths of 1 and 3 times it
    (``sst.dim_feedforward``, ``O_FFN``: K5 at (128, 128) and (128,
    384)) on the ``band`` route: ``train_and_serve``, in which K5 and its
    backward launch once a layer a step and no layer runs the unfused
    chain.  Returns the launches of the steps and frames."""
    from geomae_tpu_torch.config import apply_overrides

    total: dict = {}
    for Fd in O_FFN:
        opts = [f"sst.dim_feedforward={Fd}", BAND_OPTION]
        wp, wf = (apply_overrides(c, opts) for c in (pcfg, cfg))
        what = f"FFN {Fd}, {BAND_OPTION}"
        print(f"phase O: d_model {wp.sst.d_model}, {what}: {N_STEPS} bf16 "
              f"pretrain steps at batch {wp.data.batch_size}, one served "
              "frame")
        add_launches(total, train_and_serve(wp, wf, what, failures))
    return total


def p_step_timed(wp, route: str, what: str, failures: list) -> None:
    """``wp``'s pretrain step on ``route`` timed as ``profile_pretrain``
    times it: median and quartiles of 8 steps, peak memory, one profiled
    step's device busy ms, idle share and its SST kernels' ms, each of
    ``p_kernels(wp, route)`` launched its count a layer."""
    from pathlib import Path

    from geomae_tpu_torch import profile_pretrain

    print(f"phase P: the {what} pretrain step timed (profile_pretrain)")
    work = tempfile.mkdtemp(prefix="geomae_smoke_p_")
    try:
        res = profile_pretrain.profile(wp, Path(work) / "trace.json")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    q1, q3 = res["quartiles"]
    want = p_kernels(wp, route)
    ks = {k: res["kernels"][k] for k in want}
    print(f"  {what}: step median {res['median']:.2f} ms (quartiles "
          f"{q1:.2f}, {q3:.2f}); peak {res['peak_mib']:.0f} MiB; profiled "
          f"step busy {res['busy_ms']:.2f} ms, idle share "
          f"{res['idle_share']:.3f} against the median; SST kernels ms a "
          "step (launches): " + ", ".join(
              f"{k} {ms:.4f} ({n})" for k, (ms, n) in ks.items()))
    layers = per_pretrain_step(wp)["post_attention_block"]
    wrong = [k for k, (_, n) in ks.items()
             if n != want[k] * layers]
    if wrong or not res["busy_ms"]:
        failures.append(f"the profiled {what} step: {wrong} not "
                        f"{want} x {layers} launches, or no "
                        "device time")


def phase_p(pcfg, cfg, failures: list) -> dict:
    """The SST at d_model 384 and 512 (``P_OPTIONS``) on the ``band``
    route (K8 and K5 at C 384 and 512) and on the ``qkv`` route (K6, K7
    and their projections, K5), the 512 model with FFN 2048 (``P_FFN4``)
    on ``band``, the 384 model in 8 heads of 48 (``P_ODD``) on both
    routes, in 4 of 96 on ``band`` and in 16 of 24 and 32 of 12 on both
    routes, and the wide heads
    (``P_WIDE_HEADS``): 256 in one head of 256 and 512 in two on both
    routes, 384 in two of 192 on ``band``, 384 and 512 in one head on both
    routes, and the heads below 8 (``P_TINY``): 128 in 32 heads of 4 on
    both routes, in 128 of 1 on ``band``, 384 in 64 of 6 on ``band``, and
    the wide models (``P_WIDE_C``): 640, 768 and 1024 in heads of 64, FFN
    4 C, on both routes, each with its peak device memory:
    ``train_and_serve`` at each (on
    band K8, its prologue and backward, on qkv K6, K7, the projections
    (twice) and their backward, and K5 and its backward, once a layer a
    step, the attention and K5 once a layer a frame, no plain
    ``band_attention`` and no unfused FFN chain); then the 512 model's
    step on each route, the FFN 2048 model's, the 8-head and the
    16-head 384 model's, the two-head and one-head 512 model's and the
    32-head 128 model's on band and the 768 model's on each route timed
    (``p_step_timed``).  Returns the launches of the steps and frames."""
    from geomae_tpu_torch.config import apply_overrides

    total: dict = {}
    runs = [(C, opts, route, C == P_TIMED) for C, opts in P_OPTIONS.items()
            for route in (BAND_OPTION, QKV_OPTION)]
    runs.append((P_TIMED, P_FFN4, BAND_OPTION, True))
    runs += [(384, P_ODD[8], BAND_OPTION, True),
             (384, P_ODD[8], QKV_OPTION, False),
             (384, P_ODD[4], BAND_OPTION, False),
             (384, P_ODD[16], BAND_OPTION, True),
             (384, P_ODD[16], QKV_OPTION, False),
             (384, P_ODD[32], BAND_OPTION, False),
             (384, P_ODD[32], QKV_OPTION, False)]
    runs += [(C, P_WIDE_HEADS[C, heads], route, timed_too)
             for C, heads, route, timed_too in (
                 (256, 1, BAND_OPTION, False), (256, 1, QKV_OPTION, False),
                 (512, 2, BAND_OPTION, True), (512, 2, QKV_OPTION, False),
                 (384, 2, BAND_OPTION, False),
                 (384, 1, BAND_OPTION, False), (384, 1, QKV_OPTION, False),
                 (512, 1, BAND_OPTION, True), (512, 1, QKV_OPTION, False))]
    runs += [(C, P_TINY[C, heads], route, timed_too)
             for C, heads, route, timed_too in (
                 (128, 32, BAND_OPTION, True), (128, 32, QKV_OPTION, False),
                 (128, 128, BAND_OPTION, False),
                 (384, 64, BAND_OPTION, False))]
    runs += [(C, opts, route, C == P_WIDE_TIMED)
             for C, opts in P_WIDE_C.items()
             for route in (BAND_OPTION, QKV_OPTION)]
    timed = []
    for C, opts, route, timed_too in runs:
        wp, wf = (apply_overrides(c, opts + [route]) for c in (pcfg, cfg))
        sst = wp.sst
        what = (f"d_model {C} in {sst.nhead} heads of {C // sst.nhead}, "
                f"FFN {sst.dim_feedforward}, {route}")
        print(f"phase P: {what}: {N_STEPS} bf16 pretrain steps at batch "
              f"{wp.data.batch_size}, one served frame")
        torch.cuda.reset_peak_memory_stats()
        add_launches(total, train_and_serve(wp, wf, what, failures))
        if C in P_WIDE_C:
            print(f"  peak device memory ({what}): "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 20:.0f} MiB")
        if timed_too:
            timed.append((wp, route, what))
    for wp, route, what in timed:
        p_step_timed(wp, route, what, failures)
    # the wide models leave tens of GB in the caching allocator; phase I's
    # subprocesses need them on the card
    torch.cuda.empty_cache()
    return total


@contextlib.contextmanager
def unfused_ffn_calls():
    """Counts the SST encoder layers that run the unfused FFN chain inside
    the block (its first LayerNorm, ``norm1``, runs there and nowhere
    else): yields a list that grows by one a layer call."""
    from geomae_tpu_torch.models import sst

    init, calls = sst.EncoderLayer.__init__, []

    def counted(self, *a, **k):
        init(self, *a, **k)
        self.norm1.register_forward_hook(lambda *_: calls.append(1))

    sst.EncoderLayer.__init__ = counted
    try:
        yield calls
    finally:
        sst.EncoderLayer.__init__ = init


@contextlib.contextmanager
def plain_attention_calls():
    """Counts the SST's calls of the plain ``band_attention`` (the einsum
    route's) inside the block: yields a list that grows by one a call."""
    from geomae_tpu_torch.models import sst

    plain, calls = sst.band_attention, []
    sst.band_attention = lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        yield calls
    finally:
        sst.band_attention = plain


def phase_m(pcfg, cfg, failures: list, route: str = BAND_OPTION) -> dict:
    """The wide model (``WIDE_OPTIONS``: the VFE at (64, 256), the SST at
    d_model 256 in 8 heads of 32, FFN 512) on the attention ``route``
    (K8, or K6 and K7) and K5: bf16 pretrain steps at batch 4 with their
    launches, median, peak memory and one profiled step; frames of the
    fine-tune model served; one f32 fine-tune step at small caps on the
    card against the CPU (phase E's rules); no call of the plain
    ``band_attention``.  Returns the launches of the steps and frames."""
    from geomae_tpu_torch.apis import inference_detector, init_model
    from geomae_tpu_torch.config import apply_overrides
    from geomae_tpu_torch.profile_serving import host_ms
    from geomae_tpu_torch.synthetic import clustered_frame
    from geomae_tpu_torch.train.pretrain import (init_state, make_train_step,
                                                 synthetic_batch)

    wp, wf = (apply_overrides(c, WIDE_OPTIONS + [route]) for c in (pcfg, cfg))
    bz = wp.data.batch_size
    print(f"phase M: the wide model ({' '.join(WIDE_OPTIONS)}), {route}: "
          f"{M_STEPS} bf16 pretrain steps at batch {bz}, {M_FRAMES} served "
          f"frames, an f32 fine-tune step at small caps against the CPU")
    with plain_attention_calls() as plain:
        state = init_state(wp, DEVICE, torch.Generator().manual_seed(SEED))
        step = make_train_step(wp)
        batches = [synthetic_batch(wp, bz, seed=SEED + 90 + i,
                                   device=DEVICE) for i in range(M_STEPS)]
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats()
        fns = reset_counts()
        times = []
        for i, batch in enumerate(batches):
            (_, l), ms = host_ms(lambda: step(state, batch, gen))
            times.append(ms)
            print(f"  step {i}: {ms:.1f} ms, loss {float(l['loss']):.4f}")
            if not all(np.isfinite(float(v)) for v in l.values()):
                failures.append(f"wide pretrain step {i}: a loss is not "
                                "finite")
        launches = check_launches(fns, on_route(per_pretrain_step(wp), wp),
                                  M_STEPS, "wide pretrain steps", failures)
        qkv = launches["band_attention_qkv"] > 0
        attn = ("band_attention_qkv", "band_attention_qkv_backward") if qkv \
            else ("band_attention_fused", "band_attention_fused_backward")
        print(f"  {'K6 / K7' if qkv else 'K8 / K8 backward'} / K5 / K5 "
              f"backward a step: {launches[attn[0]] // M_STEPS} / "
              f"{launches[attn[1]] // M_STEPS} / "
              f"{launches['post_attention_block'] // M_STEPS} / "
              f"{launches['post_attention_block_backward'] // M_STEPS}; step "
              f"median {float(np.median(times[1:])):.1f} ms after the first "
              f"({times[0]:.1f} ms); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        work = tempfile.mkdtemp(prefix="geomae_smoke_wide_")
        try:
            profiled(f"wide pretrain step ({route})",
                     lambda: step(state, batches[-1], gen),
                     f"{work}/wide_pretrain_trace.json", failures)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        del state, batches

        det = init_model(cfg=wf, device=DEVICE,
                         generator=torch.Generator().manual_seed(SEED))
        frames = [clustered_frame(np.random.default_rng(SEED + 91 + f),
                                  wf.voxel, wf.caps.max_points)
                  for f in range(M_FRAMES)]
        fns = reset_counts()
        for f, raw in enumerate(frames):
            res, ms = host_ms(lambda: inference_detector(det, raw))
            n = len(res["scores"])
            print(f"  wide frame {f}: {len(raw)} points -> {n} detections "
                  f"in {ms:.1f} ms")
            if not (n and np.isfinite(res["boxes"]).all()):
                failures.append(f"wide frame {f} malformed ({n} boxes)")
        served = check_launches(fns, on_route(PER_FRAME, wf), M_FRAMES,
                                "wide frames", failures)
        del det
    print(f"  calls of the plain band_attention in the steps and frames: "
          f"{len(plain)}")
    if plain:
        failures.append(f"the wide model on {route} called the plain "
                        f"band_attention {len(plain)} times")
    phase_e(apply_overrides(wf, M_SMALL_CAPS), failures)
    return {k: launches[k] + served[k] for k in launches}


def phase_routes(cfg, inputs, failures: list) -> None:
    """One encoder layer, then one SST block (two layers), with the same
    seeded weights on the ``qkv`` route (K6) and on the ``band`` route
    (Linears, then K8), on the fine-tune batch's tokens: the two routes
    compute one function."""
    from geomae_tpu_torch.probe_routes import route_stacks, share

    print("routes: one encoder layer and one SST block, attention route "
          "band (K8) against qkv (K6), same weights")
    _, shift = inputs
    B, V = shift["layers"][0]["win_id"].shape
    g = torch.Generator().manual_seed(SEED + 7)
    stacks = route_stacks(cfg, g, DEVICE)
    x = torch.randn(B, V, cfg.sst.d_model, generator=g).to(DEVICE)
    fns = reset_counts()
    layer = {}
    for dt, tol in ROUTE_TOL.items():
        with torch.no_grad():
            # the layer takes tokens in its own sorted order: x as it is
            layer.update({(r, dt): m[0].encoder_list[0](
                x.to(dt), shift["layers"][0]) for r, m in stacks.items()})
            block = {r: m(x.to(dt), shift) for r, m in stacks.items()}
        torch.cuda.synchronize()
        name = f"{str(dt)[6:]} {tuple(x.shape)}"
        f = BLOCK_FACTOR[dt]
        compare(f"SST block {name}, max |x| "
                f"{float(block['qkv'].float().abs().max()):.3e}",
                block["band"], block["qkv"], f * tol[0], f * tol[1], failures)
        compare(f"encoder layer {name}", layer["band", dt],
                layer["qkv", dt], *tol, failures)
        if dt == torch.float32:
            continue
        f32 = torch.float32
        got = {r: share(layer[r, dt], layer[r, f32], tol)
               for r in stacks}
        ok = max(got.values()) <= LAYER_F32_LIMIT
        print(f"  encoder layer {name}, each route against its f32 layer, "
              f"share of the bound {tol[0]:g} + {tol[1]:g} relative: band "
              f"{got['band']:.3f}, qkv {got['qkv']:.3f} (limit "
              f"{LAYER_F32_LIMIT:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"encoder layer {name} against f32")
    n = 3 * len(ROUTE_TOL)
    if (fns["band_attention_qkv"].launches,
            fns["band_attention_fused"].launches) != (n, n):
        failures.append("the two routes did not launch K6 and K8 "
                        f"{n} times each")


def state_tensors(state) -> dict:
    """Every tensor of a train state by name: the model's ``state_dict``
    and the optimizer's moments."""
    out = dict(state.model.state_dict())
    for key, ts in (("mu", state.tx.mu), ("nu", state.tx.nu)):
        out.update({f"{key}.{i}": t for i, t in enumerate(ts)})
    return out


def cli_run(what: str, argv: list, per: dict, steps: int, total: dict,
            failures: list):
    """One run of the trainer CLI in process (``main(argv)``): its kernel
    launches against ``per`` a step (added to ``total``), finite logged
    losses, a train.log, and its host ms medians (``Trainer.timings``)
    and peak device memory printed.  Returns the finished trainer."""
    import os

    from geomae_tpu_torch.train.__main__ import main as train_main

    torch.cuda.reset_peak_memory_stats()
    fns = reset_counts()
    trainer = train_main(argv)
    torch.cuda.synchronize()
    launches = check_launches(fns, per, steps, f"{what} steps", failures)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    t = trainer.timings
    print(f"  {what}: host ms per step, median: " + ", ".join(
        f"{k} {float(np.median(v)):.1f}" for k, v in t.items())
        + f" (first step {t['step'][0]:.1f}; data waits "
        f"{[round(v, 1) for v in t['data']]}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    with open(os.path.join(trainer.work_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    new = [r for r in rows if r["mode"] == "train"][-steps:]
    if len(new) != steps or not all(
            np.isfinite(v) for r in new for v in r.values()
            if isinstance(v, float)):
        failures.append(f"{what}: metrics.jsonl rows missing or not "
                        f"finite ({len(new)} of {steps})")
    if not os.path.getsize(os.path.join(trainer.work_dir, "train.log")):
        failures.append(f"{what}: train.log is empty")
    return trainer


def phase_h(pcfg, cfg, failures: list) -> dict:
    """The trainer entry point on the band route; returns the launches of
    its four runs, summed."""
    import os
    import shutil
    import tempfile

    from geomae_tpu_torch.apis import inference_detector, init_model
    from geomae_tpu_torch.config import apply_overrides
    from geomae_tpu_torch.profile_serving import host_ms
    from geomae_tpu_torch.synthetic import clustered_frame
    from geomae_tpu_torch.train import finetune, pretrain
    from geomae_tpu_torch.train.checkpoint import (CheckpointManager,
                                                   load_weights)

    bz = pcfg.data.batch_size
    print(f"phase H: the trainer entry point, {pcfg.compute_dtype}, batch "
          f"{bz}, full width, attention route band: pretrain to step 3, "
          "restore, resume to 6, fine-tune 4 steps from the pretrain "
          "checkpoint, serve 2 frames from the fine-tune checkpoint")
    pcfg = apply_overrides(pcfg, [BAND_OPTION])
    cfg = apply_overrides(cfg, [BAND_OPTION])
    total: dict = {}
    work = tempfile.mkdtemp(prefix="geomae_smoke_")
    pre, ft = os.path.join(work, "pre"), os.path.join(work, "ft")
    common = ["--synthetic", "--device", DEVICE, "--batch-size", str(bz),
              "--seed", str(SEED), "--ckpt-interval", "1", "--log-interval", "1", "--cfg-options",
              BAND_OPTION]

    def run(what, argv, per, steps):
        return cli_run(what, argv, on_route(per, cfg), steps, total,
                       failures)

    def unmoved(state, fresh):
        return [k for (k, a), b in zip(state.model.named_parameters(),
                                       fresh.model.parameters())
                if torch.equal(a.detach(), b.detach())]

    try:
        tiny_cli(work, failures)
        tr = run("pretrain", ["pretrain", "--work-dir", pre, "--total-steps",
                              "3", *common], per_pretrain_step(pcfg), 3)
        fresh = lambda: pretrain.init_state(
            replace_total(pcfg, 3), DEVICE,
            torch.Generator().manual_seed(SEED))
        still = unmoved(tr.state, fresh())
        if tr.state.step != 3 or still:
            failures.append(f"pretrain: step {tr.state.step}, parameters "
                            f"that did not move: {still[:5]}")
        ckpt = os.path.join(pre, "ckpt")
        if CheckpointManager(ckpt).all_steps() != [1, 2, 3]:
            failures.append(f"checkpoints {os.listdir(ckpt)}")
        restored = CheckpointManager(ckpt).restore(fresh())
        saved, back = state_tensors(tr.state), state_tensors(restored)
        differ = [k for k in saved if not torch.equal(saved[k], back[k])]
        same = (restored.step, restored.tx.count) == (3, tr.state.tx.count)
        print(f"  restored checkpoint 3 into a fresh state: "
              f"{len(saved) - len(differ)} of {len(saved)} tensors bitwise "
              f"equal, step and update count {'equal' if same else 'DIFFER'}")
        if differ or not same or saved.keys() != back.keys():
            failures.append(f"restored state differs: {differ[:5]}")

        tr2 = run("resumed pretrain", ["pretrain", "--work-dir", pre,
                                       "--total-steps", "6", *common],
                  per_pretrain_step(pcfg), 3)
        with open(os.path.join(pre, "train.log")) as f:
            log = f.read()
        if "resumed from step 3" not in log or tr2.state.step != 6:
            failures.append("the second trainer did not resume from step 3 "
                            f"to 6 (step {tr2.state.step})")
        if CheckpointManager(ckpt).all_steps() != [4, 5, 6]:
            failures.append(f"checkpoints kept {os.listdir(ckpt)}")

        # at the config's lr: from the JAX initializer's distributions
        # (init_weights_reference) the served boxes stay finite (F2,
        # repaired; tests/test_torch_port_f2.py)
        tr3 = run("fine-tune", ["finetune", "--work-dir", ft, "--total-steps",
                                "4", "--load-from", ckpt, *common],
                  PER_STEP, 4)
        with open(os.path.join(ft, "train.log")) as f:
            log = f.read()
        start = finetune.init_state(replace_total(cfg, 4), DEVICE,
                                    torch.Generator().manual_seed(SEED))
        imported = finetune.load_pretrained(start.model,
                                            load_weights(ckpt, DEVICE))
        shared = [k for k, _ in start.model.named_parameters()
                  if k.startswith(("voxel_encoder.",
                                   "backbone.encoder_blocks."))]
        said = f"imported {len(imported)}/" in log
        print(f"  fine-tune imported {len(imported)} tensors (every VFE and "
              f"encoder-block parameter: {len(shared)}), logged: {said}")
        if sorted(imported) != sorted(shared) or not imported or not said:
            failures.append("the fine-tune run did not import every VFE and "
                            "encoder-block tensor of the pretrain checkpoint")
        still = unmoved(tr3.state, start)
        if tr3.state.step != 4 or still:
            failures.append(f"fine-tune: step {tr3.state.step}, parameters "
                            f"that did not move: {still[:5]}")

        det = init_model(checkpoint=os.path.join(ft, "ckpt"), cfg=cfg,
                         device=DEVICE)
        want = tr3.state.model.state_dict()
        differ = [k for k, v in det.model.state_dict().items()
                  if not torch.equal(v, want[k])]
        if differ:
            failures.append(f"served weights differ from the fine-tune "
                            f"state's: {differ[:5]}")
        frames = [clustered_frame(np.random.default_rng(SEED + 70 + f),
                                  cfg.voxel, cfg.caps.max_points)
                  for f in range(2)]
        fns = reset_counts()
        for f, raw in enumerate(frames):
            res, ms = host_ms(lambda: inference_detector(det, raw))
            n = len(res["scores"])
            print(f"  frame {f}: {len(raw)} points -> {n} detections in "
                  f"{ms:.1f} ms")
            ok = (n > 0 and res["boxes"].shape == (n, 9)
                  and np.isfinite(res["boxes"]).all()
                  and ((res["scores"] > 0) & (res["scores"] <= 1)).all()
                  and ((res["labels"] >= 0)
                       & (res["labels"] < cfg.head.num_classes)).all())
            if not ok:
                failures.append(
                    f"served frame {f} malformed: {n} boxes, "
                    f"{int((~np.isfinite(res['boxes'])).sum())} non-finite "
                    f"box values, scores in [{res['scores'].min()}, "
                    f"{res['scores'].max()}]")
        served = check_launches(fns, on_route(PER_FRAME, cfg), 2, "frames",
                                failures)
        for k, v in served.items():
            total[k] += v
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return total


def tiny_cli(work: str, failures: list) -> None:
    """The CLI's documented tiny run on the card: pretrain 2 steps, then
    fine-tune 2 from its checkpoint.  At the tiny width (32 in 4 heads,
    FFN 64) every SST route resolves to the plain band attention and the
    unfused chain, so no SST kernel launches; the VFE's do."""
    import os

    from geomae_tpu_torch.train.__main__ import main as train_main

    print("  tiny CLI run (--tiny, batch 2): pretrain 2 steps, fine-tune 2")
    pre, ft = os.path.join(work, "tiny_pre"), os.path.join(work, "tiny_ft")
    common = ["--synthetic", "--tiny", "--device", DEVICE, "--batch-size",
              "2", "--total-steps", "2", "--log-interval", "1", "--seed",
              str(SEED)]
    fns = reset_counts()
    tp = train_main(["pretrain", "--work-dir", pre, *common])
    tf = train_main(["finetune", "--work-dir", ft, "--load-from",
                     os.path.join(pre, "ckpt"), *common])
    torch.cuda.synchronize()
    layer = tp.state.model.backbone.encoder_blocks[0].encoder_list[0]
    sst = [k for k in fns if k.startswith(("band_attention",
                                           "post_attention"))]
    launched = {k: fns[k].launches for k in fns}
    rows = []
    for d in (pre, ft):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows += [json.loads(line) for line in f if line.strip()]
    finite = all(np.isfinite(v) for r in rows for v in r.values()
                 if isinstance(v, float))
    print(f"    steps {tp.state.step}, {tf.state.step}; routes "
          f"{layer.win_attn.route} / {'fused' if layer.fused else 'xla'}; "
          f"launches {launched}; {len(rows)} metric rows, finite: {finite}")
    if (tp.state.step, tf.state.step) != (2, 2) or not finite or not rows \
            or (layer.win_attn.route, layer.fused) != ("einsum", False) \
            or any(launched[k] for k in sst):
        failures.append("the tiny CLI run on the card")


def replace_total(cfg, total_steps: int):
    """``cfg`` with the schedule length the CLI sets from --total-steps."""
    from geomae_tpu_torch.config import replace
    return replace(cfg, optim=replace(cfg.optim, total_steps=total_steps))


DP_STEPS = 3          # phase I's one-rank NCCL steps, each way


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_step(cfg, group, device):
    """One float32 pretrain step of ``cfg`` on a seeded batch of 2 (the
    rank's row with a group) and a seeded mask generator on ``device``:
    (losses, gradients, state before, state after, lr) as
    ``compare_step`` takes them; the gradients are the ones applied
    (summed over the ranks, after the clip)."""
    from geomae_tpu_torch.config import replace
    from geomae_tpu_torch.parallel.mesh import shard_batch
    from geomae_tpu_torch.train.pretrain import (init_state, make_train_step,
                                                 synthetic_batch)

    cfg32 = replace(cfg, compute_dtype="float32")
    batch = synthetic_batch(cfg32, 2, seed=SEED + 95, device=device)
    if group is not None:
        batch = shard_batch(batch, group.rank, group.world)
    state = init_state(cfg32, device, torch.Generator().manual_seed(SEED))
    old = {k: v.detach().cpu().clone()
           for k, v in state.model.state_dict().items()}
    gen = torch.Generator(device=device).manual_seed(SEED + 95)
    _, losses = make_train_step(cfg32, group)(state, batch, gen)
    grads = {k: p.grad.detach().cpu().clone()
             for k, p in state.model.named_parameters()}
    new = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    return ({k: float(v) for k, v in losses.items()}, grads, old, new,
            state.tx.lr(0))


def gloo_rank(rank: int, port: int, work: str) -> None:
    """Phase I's rank ``rank`` of 2: a gloo group over tcp on ``port``,
    its replica on the one card (NCCL refuses two ranks on one device;
    gloo all-reduces CUDA tensors), ``dp_step`` of the config and device
    pickled in ``work``, the result saved there."""
    import os
    import pickle

    import torch.distributed as dist
    from geomae_tpu_torch.parallel.mesh import Group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(work, "cfg.pkl"), "rb") as f:
        cfg, device = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    try:
        out = dp_step(cfg, Group(rank=rank, world=2,
                                 device=torch.device(device)), device)
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_i(pcfg, failures: list) -> dict:
    """Data parallelism on the card; returns the launches of the one-rank
    NCCL steps."""
    import os
    import pickle
    import shutil
    import tempfile

    import torch.distributed as dist
    from geomae_tpu_torch.config import apply_overrides
    from geomae_tpu_torch.parallel.mesh import init_distributed
    from geomae_tpu_torch.profile_serving import host_ms
    from geomae_tpu_torch.train.pretrain import (init_state, make_train_step,
                                                 synthetic_batch)

    cfg = apply_overrides(pcfg, [BAND_OPTION])
    bz = cfg.data.batch_size
    print(f"phase I: data parallelism, pretrain, full width, band route: "
          f"{DP_STEPS} {cfg.compute_dtype} steps at batch {bz} under a "
          "one-rank NCCL group against the same steps without a group; "
          "two gloo ranks on the card against one process, one float32 "
          "step at batch 2; torchrun --nproc_per_node 1 through the CLI, "
          "3 steps, resumed to 5")
    batches = [synthetic_batch(cfg, bz, seed=SEED + 90 + i, device=DEVICE)
               for i in range(DP_STEPS)]

    def steps(group):
        state = init_state(cfg, DEVICE, torch.Generator().manual_seed(SEED))
        step = make_train_step(cfg, group)
        losses, times = [], []
        for i, b in enumerate(batches):
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 90 + i)
            (_, l), ms = host_ms(lambda: step(state, b, gen))
            losses.append(torch.stack(list(l.values())).cpu())
            times.append(ms)
        sd = {k: v.detach().clone() for k, v in
              state.model.state_dict().items()}
        return torch.stack(losses), sd, times, state.model

    alone = steps(None)
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    os.environ.update(env)
    group = init_distributed(DEVICE)
    reduce, calls = dist.all_reduce, []

    def counted(t, *a, **k):
        calls.append((t.numel(), str(t.dtype).split(".")[-1]))
        return reduce(t, *a, **k)

    dist.all_reduce = counted
    try:
        fns = reset_counts()
        grouped = steps(group)
        torch.cuda.synchronize()
        launches = check_launches(fns, on_route(per_pretrain_step(cfg), cfg),
                                  DP_STEPS, "one-rank NCCL pretrain steps",
                                  failures)
    finally:
        dist.all_reduce = reduce
        dist.destroy_process_group()
        for k in env:
            os.environ.pop(k)
    differ = [k for k in alone[1] if not torch.equal(alone[1][k],
                                                     grouped[1][k])]
    same = torch.equal(alone[0], grouped[0])
    print(f"  one-rank NCCL group against no group: losses "
          f"{'bitwise equal' if same else 'DIFFER'}, "
          f"{len(alone[1]) - len(differ)} of {len(alone[1])} state tensors "
          "(parameters and BN buffers) bitwise equal")
    if not same or differ:
        failures.append(f"one-rank group differs: losses equal {same}, "
                        f"state {differ[:5]}")
    grad_bytes = sum(p.numel() * p.element_size()
                     for p in grouped[3].parameters())
    hist: dict = {}
    for c in calls:
        hist[c] = hist.get(c, 0) + 1 / DP_STEPS
    print(f"  step ms median {float(np.median(alone[2][1:]))} without a "
          f"group, {float(np.median(grouped[2][1:]))} with (steps {alone[2]}"
          f", {grouped[2]}); gradient all-reduce {grad_bytes} bytes; "
          f"{len(calls) / DP_STEPS:g} all-reduces a step, by (elements, "
          f"dtype): {hist}")

    work = tempfile.mkdtemp(prefix="geomae_dp_")
    try:
        with open(os.path.join(work, "cfg.pkl"), "wb") as f:
            pickle.dump((cfg, DEVICE), f)
        port = free_port()
        here = os.path.dirname(os.path.abspath(__file__))
        penv = dict(os.environ, PYTHONPATH=here)
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke as s; "
             f"s.gloo_rank({r}, {port}, {work!r})"], cwd=here, env=penv,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode:
                failures.append(f"gloo rank {r} exited {p.returncode}")
                print(f"  gloo rank {r}: {out[-3000:]}")
        if not any(p.returncode for p in procs):
            ranks = [torch.load(os.path.join(work, f"rank{r}.pt"))
                     for r in range(2)]
            print(f"  two gloo ranks on {DEVICE}: "
                  f"{time.perf_counter() - t:.1f} s")
            rank_differ = [k for k in ranks[0][3]
                           if not torch.equal(ranks[0][3][k], ranks[1][3][k])]
            if rank_differ or ranks[0][0] != ranks[1][0]:
                failures.append(f"the ranks' states differ: "
                                f"{rank_differ[:5]}")
            one = dp_step(cfg, None, DEVICE)
            print(f"  losses, two ranks: {ranks[0][0]}; one process: "
                  f"{one[0]}")
            compare_step(ranks[0], one, DP_TOL, failures)
        cli = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "geomae_tpu_torch.train",
               "pretrain", "--synthetic", "--device", DEVICE, "--work-dir",
               os.path.join(work, "cli"), "--ckpt-interval", "1",
               "--log-interval", "1", "--seed", str(SEED),
               "--cfg-options", BAND_OPTION, "--total-steps"]
        for total in (3, 5):
            t = time.perf_counter()
            res = subprocess.run(cli + [str(total)], cwd=here, env=penv,
                                 capture_output=True, text=True, timeout=600)
            print(f"  torchrun to step {total}: exit {res.returncode}, "
                  f"{time.perf_counter() - t:.1f} s")
            if res.returncode:
                print(res.stdout[-2000:] + res.stderr[-3000:])
                failures.append(f"torchrun to step {total} exited "
                                f"{res.returncode}")
                return launches
        with open(os.path.join(work, "cli", "train.log")) as f:
            log = f.read()
        with open(os.path.join(work, "cli", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f if line.strip()]
        kept = sorted(os.listdir(os.path.join(work, "cli", "ckpt")))
        said = ("process group: rank 0 of 1" in log,
                "resumed from step 3" in log)
        print(f"  the CLI under torchrun: group and resume logged {said}, "
              f"metric rows at steps {[r['step'] for r in rows]}, "
              f"checkpoints {kept}")
        if not all(said) or [r["step"] for r in rows] != [1, 2, 3, 4, 5] \
                or kept != ["3.pt", "4.pt", "5.pt"] or not all(
                    np.isfinite(r["loss"]) for r in rows):
            failures.append("the CLI under torchrun")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches


# phase J's data on disk: nuScenes-schema frames of 50,000 key points and
# 9 sweeps of 25,000 (about 240k in range, the SSL set's realistic size);
# 40 frames, as CBGS keeps int(0.1 n) rows of a one-class set (every
# synthetic box is a car) and fine-tune batches take 4.  Waymo frames of
# 150,000 points with 3 sweeps overflow the 262,144-point cap.
NUS_FRAMES, NUS_POINTS, NUS_SWEEPS = 40, 50_000, 9
WAYMO_FRAMES, WAYMO_POINTS, WAYMO_SWEEPS = 12, 150_000, 3
J_PRETRAIN_STEPS, J_FINETUNE_STEPS, J_WAYMO_STEPS = 4, 4, 3


def write_waymo_infos(root: str, n_frames: int, n_points: int,
                      n_sweeps: int, pc_range) -> str:
    """A KITTI-format Waymo tree under ``root``: 6-channel ``velodyne``
    frames (x y z intensity elongation timestamp) of ``synthetic_scene``
    clouds over ``pc_range``, a slowly moving ego pose per frame, each key
    frame with ``n_sweeps`` sweeps (the earlier frames, with pose and
    timestamp), camera-frame ``annos`` and ``calib``.  Returns the info
    pickle's name."""
    import os
    import pickle

    from geomae_tpu_torch.data.synthetic import synthetic_scene

    rng = np.random.default_rng(SEED + 40)
    os.makedirs(os.path.join(root, "velodyne"), exist_ok=True)
    tr = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]],
                  np.float64)
    poses, infos = [], []
    for i in range(n_frames + n_sweeps):
        pose = np.eye(4)
        a = 0.02 * i
        pose[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]]
        pose[:3, 3] = [0.5 * i, 0.1 * i, 0.0]
        poses.append(pose)
        pts, _, _ = synthetic_scene(rng, pc_range, n_points)
        raw = np.concatenate([pts[:, :4], rng.uniform(0, 1, (n_points, 1)),
                              np.full((n_points, 1), 0.1 * i)], 1)
        raw.astype(np.float32).tofile(
            os.path.join(root, "velodyne", f"{i:06d}.bin"))
    for i in range(n_sweeps, n_frames + n_sweeps):
        infos.append(dict(
            point_cloud=dict(velodyne_path=f"velodyne/{i:06d}.bin",
                             num_features=6),
            pose=poses[i], timestamp=i * 100_000,
            sweeps=[dict(velodyne_path=f"velodyne/{i - 1 - j:06d}.bin",
                         pose=poses[i - 1 - j],
                         timestamp=(i - 1 - j) * 100_000)
                    for j in range(n_sweeps)],
            calib=dict(R0_rect=np.eye(4), Tr_velo_to_cam=tr),
            annos=dict(name=np.array(["Car", "Pedestrian"]),
                       location=np.array([[2.0, 1.0, 10.0],
                                          [-3.0, 1.0, 20.0]]),
                       dimensions=np.array([[4.0, 1.5, 1.8],
                                            [0.8, 1.7, 0.8]]),
                       rotation_y=np.array([0.3, -1.2]))))
    with open(os.path.join(root, "waymo_infos_train.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return "waymo_infos_train.pkl"


def sample_ms(ds, n: int = 3):
    """Valid points and host ms of ``ds``'s first ``n`` training samples,
    one at a time on this thread."""
    counts, times = [], []
    for i in range(n):
        t = time.perf_counter()
        s = ds.__getitem__(i, seed=SEED + i)
        times.append(round((time.perf_counter() - t) * 1e3, 1))
        counts.append(int(s["point_valid"].sum()))
    return counts, times


def phase_j(pcfg, cfg, wcfg, failures: list, work: str) -> dict:
    """Training from disk through the CLI on the band route, its files and
    runs under ``work`` (phase K reads them): returns the launches of its
    runs, summed."""
    import os

    from geomae_tpu_torch.apis import inference_detector, init_model
    from geomae_tpu_torch.config import apply_overrides
    from geomae_tpu_torch.data.nuscenes import NuScenesDetDataset
    from geomae_tpu_torch.data.synthetic import write_synthetic_infos
    from geomae_tpu_torch.profile_serving import host_ms
    from geomae_tpu_torch.train.pretrain import make_train_step

    bz = pcfg.data.batch_size
    pcfg, cfg, wcfg = (apply_overrides(c, [BAND_OPTION])
                       for c in (pcfg, cfg, wcfg))
    print(f"phase J: training from disk through the CLI, "
          f"{pcfg.compute_dtype}, batch {bz}, full width, band route: "
          f"nuScenes pretrain {J_PRETRAIN_STEPS} steps, fine-tune "
          f"{J_FINETUNE_STEPS} with CBGS from its checkpoint at the "
          f"config's lr, one test-mode frame served, Waymo pretrain "
          f"{J_WAYMO_STEPS} steps")
    total: dict = {}
    nus, way = os.path.join(work, "nus"), os.path.join(work, "waymo")
    pre, ft = os.path.join(work, "pre"), os.path.join(work, "ft")
    t = time.perf_counter()
    write_synthetic_infos(nus, NUS_FRAMES, NUS_POINTS, NUS_SWEEPS)
    ann = write_waymo_infos(way, WAYMO_FRAMES, WAYMO_POINTS,
                            WAYMO_SWEEPS, wcfg.voxel.point_cloud_range)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(work) for f in fs)
    print(f"  wrote {NUS_FRAMES} nuScenes frames ({NUS_POINTS} points, "
          f"{NUS_SWEEPS} sweeps) and {WAYMO_FRAMES} Waymo frames "
          f"({WAYMO_POINTS} points, {WAYMO_SWEEPS} sweeps): "
          f"{size / 1e6:.0f} MB in {time.perf_counter() - t:.1f} s")
    common = ["--device", DEVICE, "--batch-size", str(bz), "--seed",
              str(SEED), "--log-interval", "1", "--cfg-options",
              BAND_OPTION]
    nus_args = ["--data-root", nus, "--ann-file", "infos.pkl"]
    tr = cli_run("pretrain from disk", [
        "pretrain", "--work-dir", pre, "--total-steps",
        str(J_PRETRAIN_STEPS), *nus_args, *common],
        on_route(per_pretrain_step(pcfg), cfg), J_PRETRAIN_STEPS, total,
        failures)
    n, ms = sample_ms(tr.loader.dataset)
    print(f"    NuScenesSSLDataset (native: {tr.loader.dataset.native}):"
          f" {n} valid points (cap {pcfg.caps.max_points}), host ms "
          f"per sample {ms}")
    tr2 = cli_run("fine-tune from disk, CBGS", [
        "finetune", "--work-dir", ft, "--total-steps",
        str(J_FINETUNE_STEPS), "--cbgs", "--load-from",
        os.path.join(pre, "ckpt"), *nus_args, *common],
        on_route(PER_STEP, cfg), J_FINETUNE_STEPS, total, failures)
    ds = tr2.loader.dataset
    n, ms = sample_ms(ds)
    print(f"    {type(ds).__name__}: {len(ds)} rows of {NUS_FRAMES} "
          f"frames; lr {tr2.state.model.cfg.optim.lr}; {n} valid "
          f"points, host ms per sample {ms}")
    if type(ds).__name__ != "CBGSDataset" or not len(ds):
        failures.append(f"fine-tune from disk read {type(ds).__name__} "
                        f"of {len(ds)} rows")

    det = init_model(checkpoint=os.path.join(ft, "ckpt"), cfg=cfg,
                     device=DEVICE)
    frame = NuScenesDetDataset(tr2.state.model.cfg.data, cfg.voxel,
                               cfg.caps, test_mode=True)[0]
    pts = frame["points"][frame["point_valid"]]
    fns = reset_counts()
    res, ms = host_ms(lambda: inference_detector(det, pts))
    k = len(res["scores"])
    print(f"  served a test-mode frame: {len(pts)} points -> {k} "
          f"detections in {ms:.1f} ms, finite: "
          f"{bool(np.isfinite(res['boxes']).all())}")
    if not (k > 0 and np.isfinite(res["boxes"]).all()):
        failures.append(f"served frame from disk: {k} boxes, "
                        f"{int((~np.isfinite(res['boxes'])).sum())} "
                        f"non-finite values")
    served = check_launches(fns, on_route(PER_FRAME, cfg), 1, "frames",
                            failures)
    for name, v in served.items():
        total[name] += v

    tr3 = cli_run("Waymo pretrain from disk", [
        "pretrain", "--preset", "waymo", "--work-dir",
        os.path.join(work, "wpre"), "--total-steps", str(J_WAYMO_STEPS),
        "--data-root", way, "--ann-file", ann, *common],
        on_route(per_pretrain_step(wcfg), cfg), J_WAYMO_STEPS, total,
        failures)
    wc = tr3.state.model.cfg
    if (wc.voxel.grid_size, wc.caps.max_voxels) != ((468, 468), 24576):
        failures.append(f"the Waymo preset ran {wc.voxel.grid_size}, "
                        f"{wc.caps.max_voxels} pillars")
    # one more Waymo step under the profiler: the device's busy time
    ws = tr3.loader.dataset
    n, ms = sample_ms(ws)
    print(f"    WaymoSSLDataset: {n} valid points (cap "
          f"{wc.caps.max_points}), host ms per sample {ms}")
    batch = {key: torch.from_numpy(np.stack(
        [ws.__getitem__(i, seed=SEED)[key] for i in range(bz)]))
        .to(DEVICE) for key in ("points", "point_valid")}
    step = make_train_step(wc)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    host_ms(lambda: step(tr3.state, batch, gen))
    profiled("Waymo pretrain step", lambda: step(tr3.state, batch, gen),
             os.path.join(work, "waymo_trace.json"), failures)
    return total


K_STEPS = 4            # phase K's CenterHead fine-tune steps from disk
K_EVAL_FRAMES = 8      # test-mode frames the eval CLI scores


def phase_k(cfg, failures: list, work: str) -> dict:
    """The CenterHead (``geomae_finetune_nus_centerhead()``) and the eval
    entry point on the band route, from phase J's files under ``work``:
    returns the launches of its steps and frames, summed."""
    import os

    from geomae_tpu_torch import test as eval_cli
    from geomae_tpu_torch.apis import inference_detector, init_model
    from geomae_tpu_torch.config import (apply_overrides,
                                         geomae_finetune_nus_centerhead)
    from geomae_tpu_torch.data.nuscenes import NUS_CLASSES, NuScenesDetDataset
    from geomae_tpu_torch.eval.nuscenes_eval import evaluate
    from geomae_tpu_torch.profile_serving import host_ms, stage_ms
    from geomae_tpu_torch.train import finetune

    ccfg = apply_overrides(geomae_finetune_nus_centerhead(), [BAND_OPTION])
    cfg = apply_overrides(cfg, [BAND_OPTION])
    ch = ccfg.center_head
    bz = ccfg.data.batch_size
    print(f"phase K: the CenterHead ({ccfg.voxel.grid_size[0]} x "
          f"{ccfg.voxel.grid_size[1]} pillars of {ccfg.voxel.voxel_size[0]} "
          f"m, {len(ch.tasks)} tasks, {ch.num_classes} classes), "
          f"{ccfg.compute_dtype}, batch {bz}, full width, band route: "
          f"fine-tune {K_STEPS} steps from disk through the CLI, a repeated "
          f"batch, {FRAMES} frames served from its checkpoint, test-time "
          f"augmentation, f32 GPU against CPU; the eval CLI on phase J's "
          f"fine-tune checkpoint over {K_EVAL_FRAMES} frames")
    total: dict = {}
    nus, cft = os.path.join(work, "nus"), os.path.join(work, "cft")
    common = ["--device", DEVICE, "--batch-size", str(bz), "--seed",
              str(SEED), "--log-interval", "1", "--cfg-options", BAND_OPTION]

    # 1. fine-tune from disk through the CLI
    tr = cli_run("CenterHead fine-tune from disk", [
        "finetune", "--preset", "nus_centerhead", "--work-dir", cft,
        "--total-steps", str(K_STEPS), "--data-root", nus, "--ann-file",
        "infos.pkl", *common], on_route(PER_STEP, ccfg), K_STEPS, total,
        failures)
    with open(os.path.join(cft, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    terms = [f"task{i}.loss_{k}" for i in range(len(ch.tasks))
             for k in ("heatmap", "bbox")] + ["loss"]
    if len(rows) != K_STEPS or not all(
            np.isfinite(r.get(k, np.nan)) for r in rows for k in terms):
        failures.append(f"CenterHead losses missing or not finite: {rows}")
    print(f"    losses of the last step: " + ", ".join(
        f"{k} {rows[-1].get(k, float('nan')):.4f}" for k in terms))
    run_cfg = tr.state.model.cfg
    ds = tr.loader.dataset
    batch = {key: torch.from_numpy(np.stack(
        [ds.__getitem__(i, seed=SEED)[key] for i in range(bz)])).to(DEVICE)
        for key in ("points", "point_valid", "gt_boxes", "gt_labels",
                    "gt_mask")}
    step = finetune.make_train_step(run_cfg)
    host_ms(lambda: step(tr.state, batch))
    profiled("CenterHead fine-tune step", lambda: step(tr.state, batch),
             os.path.join(work, "center_step_trace.json"), failures)

    # 2. a repeated batch in process: the loss falls
    state = finetune.init_state(ccfg, DEVICE,
                                torch.Generator().manual_seed(SEED))
    step = finetune.make_train_step(ccfg)
    batches = [finetune.synthetic_batch(ccfg, bz, seed=SEED + 30 + i,
                                        device=DEVICE)
               for i in range(DISTINCT)]
    n = DISTINCT + BAND_REPEAT
    fns = reset_counts()
    losses, times = [], []
    for i in range(n):
        b = batches[min(i, DISTINCT - 1)]
        (_, lo), ms = host_ms(lambda: step(state, b))
        losses.append(float(lo["loss"]))
        times.append(ms)
        if not all(np.isfinite(float(v)) for v in lo.values()):
            failures.append(f"CenterHead step {i}: a loss is not finite")
    launches = check_launches(fns, on_route(PER_STEP, ccfg), n,
                              "CenterHead train steps", failures)
    for k, v in launches.items():
        total[k] += v
    rep = losses[DISTINCT - 1:]
    print(f"  in process: losses {[round(v, 4) for v in losses]}; on the "
          f"repeated batch {rep[0]:.4f} -> {rep[-1]:.4f} over {len(rep) - 1} "
          f"steps; step median {float(np.median(times[1:])):.1f} ms")
    if not rep[-1] < rep[0]:
        failures.append("the CenterHead loss did not fall on the repeated "
                        "batch")
    del state, batches

    # 3. serve from the checkpoint
    det = init_model(checkpoint=os.path.join(cft, "ckpt"), cfg=ccfg,
                     device=DEVICE)
    test_ds = NuScenesDetDataset(run_cfg.data, ccfg.voxel, ccfg.caps,
                                 test_mode=True)
    frames = []
    for i in range(FRAMES):
        f = test_ds[i]
        frames.append(f["points"][f["point_valid"]])
    fns = reset_counts()
    served, ms_all = [], []
    for f, pts in enumerate(frames):
        res, ms = host_ms(lambda: inference_detector(det, pts))
        served.append(res)
        ms_all.append(ms)
        k = len(res["scores"])
        ok = (0 < k <= ch.topk and res["boxes"].shape == (k, 9)
              and np.isfinite(res["boxes"]).all()
              and ((res["labels"] >= 0)
                   & (res["labels"] < ch.num_classes)).all()
              and (res["scores"] > ch.score_threshold).all())
        print(f"  frame {f}: {len(pts)} points -> {k} detections in "
              f"{ms:.1f} ms")
        if not ok:
            failures.append(f"CenterHead frame {f} malformed: {k} boxes")
    # 4. test-time augmentation: four flips of the last frame
    (merged, ms) = host_ms(lambda: det.aug_test(frames[-1]))
    print(f"  aug_test (4 flips): {len(merged['scores'])} merged boxes in "
          f"{ms:.1f} ms, finite: {bool(np.isfinite(merged['boxes']).all())}")
    if not (len(merged["scores"]) and np.isfinite(merged["boxes"]).all()):
        failures.append("aug_test's merged boxes")
    launches = check_launches(fns, on_route(PER_FRAME, ccfg), FRAMES + 4,
                              "CenterHead frames (3 served, 4 flipped)",
                              failures)
    for k, v in launches.items():
        total[k] += v
    print(f"  served frame median {float(np.median(ms_all)):.1f} ms")
    stages = stage_ms(det, frames[-1])
    print("  stages of one more frame (ms): " + ", ".join(
        f"{k} {v:.1f}" for k, v in stages.items()))
    profiled("CenterHead served frame",
             lambda: inference_detector(det, frames[0]),
             os.path.join(work, "center_frame_trace.json"), failures)

    # 5. f32 GPU against CPU: a frame (with the NMS keep masks), a step
    og, oc = phase_c(ccfg, failures)
    compare_center_nms(og, oc, ccfg, failures)
    phase_e(ccfg, failures)

    # 6. the eval entry point on phase J's anchor fine-tune checkpoint
    results = {}
    for wnms in (False, True):
        out = os.path.join(work, f"results_{wnms}.json")
        argv = ["--work-dir", os.path.join(work, "ft"), "--data-root", nus,
                "--ann-file", "infos.pkl", "--max-frames",
                str(K_EVAL_FRAMES), "--device", DEVICE, "--out", out,
                "--cfg-options", BAND_OPTION] + (["--wnms"] if wnms else [])
        fns = reset_counts()
        metrics, ms = host_ms(lambda: eval_cli.main(argv))
        with open(out) as f:
            tokens = list(json.load(f)["results"])
        # one forward a batch of 4 frames
        launches = check_launches(fns, on_route(PER_FRAME, cfg),
                                  -(-K_EVAL_FRAMES // 4),
                                  "eval batches", failures)
        for k, v in launches.items():
            total[k] += v
        results[wnms] = metrics
        print(f"  eval CLI{' --wnms' if wnms else ''}: {ms:.0f} ms for "
              f"{K_EVAL_FRAMES} frames, restore included "
              f"({ms / K_EVAL_FRAMES:.1f} ms a frame); mAP "
              f"{metrics['mAP']:.4f}, NDS {metrics['NDS']:.4f}; "
              f"{len(tokens)} tokens in the results JSON")
        if (len(tokens) != K_EVAL_FRAMES
                or not all(np.isfinite(v) and v >= 0
                           for v in metrics.values())
                or not (0 <= metrics["mAP"] <= 1 and 0 <= metrics["NDS"] <= 1)):
            failures.append(f"eval CLI (wnms {wnms}): {metrics}, "
                            f"{len(tokens)} tokens")

    # 7. the CenterHead's served frames scored in process
    gts = []
    for i in range(FRAMES):
        b, lab = test_ds.get_ann(i)
        gts.append(dict(boxes=b, labels=lab))
    m = evaluate(served, gts, NUS_CLASSES)
    own = evaluate([dict(g, scores=np.ones(len(g["labels"]), np.float32))
                    for g in gts], gts, NUS_CLASSES)
    print(f"  served CenterHead frames scored: mAP {m['mAP']:.4f}, NDS "
          f"{m['NDS']:.4f}; the ground truth as its own prediction: mAP "
          f"{own['mAP']!r}")
    if not all(np.isfinite(v) for v in m.values()) \
            or abs(own["mAP"] - 1.0) > 1e-12:
        failures.append(f"scoring the served frames: {m}, {own}")
    return total


def compare_center_nms(og, oc, cfg, failures: list) -> None:
    """The CenterHead's rotated NMS on the card against the CPU, on the
    same candidates (the CPU decode's, every task at once): the keep
    masks equal, but in a ranking where some pair's IoU lies within 1e-5
    of the threshold on either device."""
    from geomae_tpu_torch.models.center_head import decode_task
    from geomae_tpu_torch.ops.rotated_iou import (boxes_iou_bev_batched,
                                                  nms_bev)

    ch = cfg.center_head
    dec = [decode_task(p, ch, cfg.voxel) for p in oc]
    boxes = torch.stack([d[0][0][:, [0, 1, 3, 4, 6]] for d in dec])
    ok = torch.stack([d[3][0] for d in dec])
    scores = torch.stack([d[1][0] for d in dec])
    keep = {}
    near = torch.zeros(len(dec), dtype=torch.bool)
    for dev in ("cpu", DEVICE):
        b = boxes.to(dev)
        keep[dev] = nms_bev(b, scores.to(dev), ok.to(dev), ch.nms_thr,
                            ch.post_max_size).cpu()
        iou = boxes_iou_bev_batched(b).cpu()
        near |= ((iou - ch.nms_thr).abs() < 1e-5).flatten(1).any(1)
    differ = (keep["cpu"] != keep[DEVICE]).any(1)
    print(f"  NMS keep masks over {tuple(boxes.shape[:2])} candidates: "
          f"{int(keep['cpu'].sum())} kept on the CPU, "
          f"{int(keep[DEVICE].sum())} on the card; tasks that differ "
          f"{differ.nonzero().flatten().tolist()}, tasks with an IoU near "
          f"the threshold {near.nonzero().flatten().tolist()}")
    if bool((differ & ~near).any()):
        failures.append("CenterHead NMS keep masks differ between the card "
                        "and the CPU")


# phase L: data preparation, then training from its files; VoxelNet at
# full width; the point ops.  The raw Waymo tree has phase J's Waymo size
# (150,000-point frames, 3 sweeps): 12 train frames (segment 0) and 4 val
# (segment 1).  GT paste tops every sample up to L_PASTE_CARS cars, as
# phase J's frames hold cars only (12 a frame).
L_TRAIN_FRAMES, L_VAL_FRAMES = 12, 4
L_WAYMO_STEPS, L_PASTE_STEPS, L_PASTE_CARS = 3, 2, 20
L_FRAMES, L_WARMUP = 10, 3          # VoxelNet's timed and warm-up frames
# GPU against CPU for the point ops: squared distances (m^2) as the two
# devices round |c|^2 + |x|^2 - 2 c.x; an index is held exactly where the
# margin between candidates exceeds it
POINT_TOL = 1e-4
PN_B, PN_N, PN_S, PN_C = 4, 16_384, 1_024, 128


def run_module(what: str, argv: list, failures: list) -> float:
    """``python -m argv`` in a subprocess from the checkout: its seconds,
    and a failure where it exits non-zero."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *argv], cwd=here,
                         env=dict(os.environ, PYTHONPATH=here),
                         capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t
    tail = res.stdout.strip().splitlines()[-3:]
    print(f"  {what}: exit {res.returncode} in {secs:.1f} s; {tail}")
    if res.returncode:
        print(res.stdout[-2000:] + res.stderr[-3000:])
        failures.append(f"{what} exited {res.returncode}")
    return secs


def write_raw_waymo(root: str, n_points: int, pc_range) -> None:
    """A raw KITTI-format Waymo tree, the layout the devkit half of
    ``data/waymo_converter.py`` writes: ``training/velodyne`` frames of
    ``synthetic_scene`` clouds (x y z intensity elongation timestamp),
    ``label_all`` lines of their boxes (``waymo_label_to_kitti_line``),
    ``calib`` (``format_calib``), a moving ego ``pose`` a frame, and
    ``ImageSets`` train / val lists."""
    import os

    from geomae_tpu_torch.data import waymo_converter as wc
    from geomae_tpu_torch.data.synthetic import synthetic_scene

    rng = np.random.default_rng(SEED + 60)
    sd = os.path.join(root, "training")
    for sub in ("velodyne", "calib", "pose", "label_all"):
        os.makedirs(os.path.join(sd, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    ext = np.eye(4)                   # the front camera, 1.5 m ahead, 2 up
    ext[:3, 3] = [1.5, 0.0, 2.0]
    T = wc.velo_to_front_cam(ext)
    P = np.hstack([np.diag([2000.0, 2000.0, 1.0]), np.zeros((3, 1))])
    calib = wc.format_calib([P] * 5, [T] * 5)
    names = ("Car", "Pedestrian", "Cyclist")
    splits = {"train": [f"0000{f:03d}" for f in range(L_TRAIN_FRAMES)],
              "val": [f"1000{f:03d}" for f in range(L_VAL_FRAMES)]}
    for split, ids in splits.items():
        with open(os.path.join(root, "ImageSets", f"{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
        for i, fid in enumerate(ids):
            pts, boxes, labels = synthetic_scene(rng, pc_range, n_points)
            raw = np.concatenate([pts[:, :4], rng.uniform(0, 1, (n_points, 1)),
                                  np.full((n_points, 1), 1e5 * i)], 1)
            raw.astype(np.float32).tofile(
                os.path.join(sd, "velodyne", f"{fid}.bin"))
            pose = np.eye(4)
            a = 0.02 * i
            pose[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
            pose[:3, 3] = [0.5 * i, 0.1 * i, 0.0]
            np.savetxt(os.path.join(sd, "pose", f"{fid}.txt"), pose)
            with open(os.path.join(sd, "calib", f"{fid}.txt"), "w") as f:
                f.write(calib)
            lines = [wc.waymo_label_to_kitti_line(names[int(lab) % 3],
                                                  b[:7], T)
                     for b, lab in zip(boxes, labels)]
            with open(os.path.join(sd, "label_all", f"{fid}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")


def phase_l_data(cfg, wcfg, failures: list, work: str) -> dict:
    """Convert a raw Waymo tree and train and score from its infos; build
    the GT database of phase J's nuScenes frames and fine-tune with GT
    paste: returns the launches of the runs."""
    import os
    import pickle

    from geomae_tpu_torch import test as eval_cli
    from geomae_tpu_torch.config import apply_overrides, replace
    from geomae_tpu_torch.data.dbsampler import DataBaseSampler
    from geomae_tpu_torch.data.nuscenes import NUS_CLASSES, NuScenesDetDataset
    from geomae_tpu_torch.profile_serving import host_ms
    from geomae_tpu_torch.train import finetune

    cfg, wcfg = (apply_overrides(c, [BAND_OPTION]) for c in (cfg, wcfg))
    bz = cfg.data.batch_size
    total: dict = {}
    raw = os.path.join(work, "waymo_raw")
    t = time.perf_counter()
    write_raw_waymo(raw, WAYMO_POINTS, wcfg.voxel.point_cloud_range)
    print(f"  wrote a raw KITTI-format Waymo tree ({L_TRAIN_FRAMES} + "
          f"{L_VAL_FRAMES} frames of {WAYMO_POINTS} points) in "
          f"{time.perf_counter() - t:.1f} s")
    before = len(failures)
    run_module("create_data waymo_infos", [
        "geomae_tpu_torch.create_data", "waymo_infos", "--root-path", raw,
        "--max-sweeps", str(WAYMO_SWEEPS)], failures)
    if len(failures) > before:
        raise Failed(f"phase L: {failures}")
    infos = {}
    for split in ("train", "val", "trainval"):
        with open(os.path.join(raw, f"waymo_infos_{split}.pkl"), "rb") as f:
            infos[split] = pickle.load(f)
    counts = [int(n) for i in infos["train"]
              for n in i["annos"]["num_points_in_gt"]]
    sweeps = [len(i["sweeps"]) for i in infos["train"]]
    print(f"  infos: {[len(v) for v in infos.values()]} (train, val, "
          f"trainval); sweeps a train frame {sweeps}; {len(counts)} boxes, "
          f"points in a box min {min(counts)} median "
          f"{float(np.median(counts))}")
    if ([len(v) for v in infos.values()]
            != [L_TRAIN_FRAMES, L_VAL_FRAMES, L_TRAIN_FRAMES + L_VAL_FRAMES]
            or max(sweeps) != WAYMO_SWEEPS or not np.median(counts) > 0):
        failures.append("the converted Waymo infos")
    common = ["--device", DEVICE, "--batch-size", str(bz), "--seed",
              str(SEED), "--log-interval", "1", "--cfg-options",
              BAND_OPTION]
    tr = cli_run("Waymo pretrain from the converted infos", [
        "pretrain", "--preset", "waymo", "--work-dir",
        os.path.join(work, "lpre"), "--total-steps", str(L_WAYMO_STEPS),
        "--data-root", raw, "--ann-file", "waymo_infos_train.pkl",
        *common], on_route(per_pretrain_step(wcfg), cfg), L_WAYMO_STEPS,
        total, failures)
    n, ms = sample_ms(tr.loader.dataset)
    print(f"    WaymoSSLDataset: {n} valid points, host ms per sample {ms}")
    argv = ["--work-dir", os.path.join(work, "ft"), "--dataset", "waymo",
            "--data-root", raw, "--ann-file", "waymo_infos_val.pkl",
            "--device", DEVICE, "--cfg-options", BAND_OPTION,
            "data.load_dim=6"]
    fns = reset_counts()
    metrics, ms = host_ms(lambda: eval_cli.main(argv))
    launches = check_launches(fns, on_route(PER_FRAME, cfg),
                              -(-L_VAL_FRAMES // 4), "eval batches",
                              failures)
    for k, v in launches.items():
        total[k] += v
    print(f"  eval CLI on the converted val infos (--dataset waymo): "
          f"{ms:.0f} ms for {L_VAL_FRAMES} frames; {metrics}")
    if not metrics or not all(np.isfinite(v) for v in metrics.values()):
        failures.append(f"eval CLI on the converted Waymo infos: {metrics}")

    # the GT database of phase J's nuScenes frames, then GT paste
    nus, db = os.path.join(work, "nus"), os.path.join(work, "gtdb")
    before = len(failures)
    run_module("create_data gt_database", [
        "geomae_tpu_torch.create_data", "gt_database", "--root-path", nus,
        "--ann-file", "infos.pkl", "--out-dir", db], failures)
    if len(failures) > before:
        raise Failed(f"phase L: {failures}")
    with open(os.path.join(db, "nuscenes_dbinfos_train.pkl"), "rb") as f:
        dbinfos = pickle.load(f)
    objs = {k: len(v) for k, v in dbinfos.items() if v}
    print(f"  GT database: {objs} objects, "
          f"{len(os.listdir(os.path.join(db, 'gt_database')))} files")
    if not objs.get("car"):
        failures.append("the GT database holds no car")
    data = replace(cfg.data, data_root=nus, ann_file="infos.pkl")
    sampler = DataBaseSampler(db, os.path.join(db, "nuscenes_dbinfos_train"
                                               ".pkl"), NUS_CLASSES,
                              sample_groups=dict(car=L_PASTE_CARS))
    ds = NuScenesDetDataset(data, cfg.voxel, cfg.caps, cfg.max_gt_boxes,
                            db_sampler=sampler)
    plain = NuScenesDetDataset(data, cfg.voxel, cfg.caps, cfg.max_gt_boxes)
    samples, times, pasted = [], [], []
    for i in range(bz * L_PASTE_STEPS):
        t = time.perf_counter()
        samples.append(ds.__getitem__(i, seed=SEED + i))
        times.append(round((time.perf_counter() - t) * 1e3, 1))
        pasted.append(int(samples[-1]["gt_mask"].sum()) - int(
            plain.__getitem__(i, seed=SEED + i)["gt_mask"].sum()))
    print(f"  GT paste: objects pasted per sample (boxes with paste less "
          f"without) {pasted}; host ms per sample with paste {times}")
    if not sum(pasted) > 0:
        failures.append("GT paste pasted nothing")
    state = finetune.init_state(cfg, DEVICE,
                                torch.Generator().manual_seed(SEED))
    step = finetune.make_train_step(cfg)
    fns = reset_counts()
    for s in range(L_PASTE_STEPS):
        batch = {k: torch.from_numpy(np.stack(
            [x[k] for x in samples[s * bz:(s + 1) * bz]])).to(DEVICE)
            for k in ("points", "point_valid", "gt_boxes", "gt_labels",
                      "gt_mask")}
        (_, lo), ms = host_ms(lambda: step(state, batch))
        print(f"    fine-tune step {s} with GT paste: {ms:.1f} ms, losses "
              + ", ".join(f"{k} {float(v):.4f}" for k, v in lo.items()))
        if not all(np.isfinite(float(v)) for v in lo.values()):
            failures.append(f"GT-paste step {s}: a loss is not finite")
    launches = check_launches(fns, on_route(PER_STEP, cfg), L_PASTE_STEPS,
                              "GT-paste fine-tune steps", failures)
    for k, v in launches.items():
        total[k] += v
    return total


def voxelnet(cfg, encoder: str, device):
    """A full-width ``VoxelNet`` on ``device`` from seeded weights (drawn
    on the CPU: the same on every device), in eval mode."""
    from geomae_tpu_torch.models.detector import VoxelNet, init_weights

    model = VoxelNet(cfg, encoder, device="meta").to_empty(device=device)
    init_weights(model, torch.Generator().manual_seed(SEED))
    return model.eval()


def phase_l_voxelnet(cfg, failures: list, work: str) -> dict:
    """``VoxelNet`` with either encoder: an f32 frame and (pillar) an f32
    backward on the card against the CPU, bf16 frames served and timed,
    and ``HardVFE`` at the full-width buffer; returns the served frames'
    launches."""
    import os

    from geomae_tpu_torch.apis import replace, to_batch
    from geomae_tpu_torch.models.anchor_head import predict
    from geomae_tpu_torch.models.anchors import grid_anchors, head_featmap_size
    from geomae_tpu_torch.models.detector import extract_scene, init_weights
    from geomae_tpu_torch.models.pillar_encoders import HardVFE
    from geomae_tpu_torch.ops.voxelize import hard_voxelize
    from geomae_tpu_torch.profile_serving import host_ms
    from geomae_tpu_torch.synthetic import clustered_frame
    from geomae_tpu_torch.train.finetune import (make_train_step,
                                                 synthetic_batch)

    total: dict = {}
    cfg32 = replace(cfg, compute_dtype="float32")
    frames = [clustered_frame(np.random.default_rng(SEED + 70 + f),
                              cfg.voxel, cfg.caps.max_points)
              for f in range(L_WARMUP + L_FRAMES)]
    anchors = torch.from_numpy(grid_anchors(
        cfg.head, head_featmap_size(cfg))).to(DEVICE)
    for encoder in ("pillar", "simple"):
        what = f"VoxelNet ({encoder})"
        # 1. one f32 frame, GPU against CPU
        outs = {}
        for dev in (DEVICE, "cpu"):
            t = time.perf_counter()
            model = voxelnet(cfg32, encoder, dev)
            with torch.no_grad():
                outs[dev] = model(extract_scene(
                    cfg32, *to_batch(cfg32, frames[0], dev)))
            print(f"  {what} f32 frame on {dev}: "
                  f"{time.perf_counter() - t:.1f} s")
        for name in ("cls", "reg", "dir"):
            b = getattr(outs["cpu"], name)
            compare(f"{what} f32 head {name} {tuple(b.shape)}, std "
                    f"{float(b.std()):.3e}", getattr(outs[DEVICE], name).cpu(),
                    b, *PARITY_TOL, failures)
        # 2. (pillar) one f32 backward of the fine-tune loss
        if encoder == "pillar":
            batch = synthetic_batch(cfg32, 1, seed=SEED + 50, device="cpu")
            loss_fn = make_train_step(cfg32).loss_fn
            got = {}
            for dev in (DEVICE, "cpu"):
                model = voxelnet(cfg32, encoder, dev).train()
                lo = loss_fn(model, {k: v.to(dev) for k, v in batch.items()})
                lo["loss"].backward()
                got[dev] = ({k: float(v.detach()) for k, v in lo.items()},
                            {k: p.grad.cpu() for k, p in
                             model.named_parameters()})
            (lg, gg), (lc, gc) = got[DEVICE], got["cpu"]
            rel = {k: float((gg[k] - gc[k]).norm()
                            / gc[k].norm().clamp_min(1e-30)) for k in gc}
            worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
            print(f"  {what} f32 backward: losses GPU {lg} CPU {lc}; "
                  f"gradients' worst relative norm errors {worst} (bound "
                  f"{STEP_TOL['grad']:g}, {len(rel)} parameters)")
            failures += [f"{what} gradient {k}: {e:.2e}"
                         for k, e in rel.items() if not e <= STEP_TOL["grad"]]
            failures += [f"{what} loss {k}" for k in lc if abs(
                lg[k] - lc[k]) > STEP_TOL["loss"] * max(abs(lc[k]), 1e-12)]
        # 3. bf16 frames served and timed
        model = voxelnet(cfg, encoder, DEVICE)

        @torch.no_grad()
        def serve(pts):
            scene = extract_scene(cfg, *to_batch(cfg, pts, DEVICE))
            det = predict(model(scene), anchors, cfg.head)
            m = det.valid[0].cpu().numpy()
            return {k: getattr(det, k)[0].cpu().numpy()[m]
                    for k in ("boxes", "scores", "labels")}
        for pts in frames[:L_WARMUP]:
            serve(pts)
        fns = reset_counts()
        ms_all = []
        for f, pts in enumerate(frames[L_WARMUP:]):
            res, ms = host_ms(lambda: serve(pts))
            ms_all.append(ms)
            k = len(res["scores"])
            if not (k > 0 and res["boxes"].shape == (k, 9)
                    and np.isfinite(res["boxes"]).all()):
                failures.append(f"{what} frame {f}: {k} boxes")
        per = dict({k: 0 for k in PER_FRAME})
        if encoder == "pillar":
            per.update(segment_reduce=1, segment_broadcast=2)
        launches = check_launches(fns, per, L_FRAMES, f"{what} frames",
                                  failures)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        q = np.percentile(ms_all, [25, 50, 75])
        print(f"  {what} bf16 served frames: median {q[1]:.2f} ms "
              f"(quartiles {q[0]:.2f}, {q[2]:.2f}) over {L_FRAMES} after "
              f"{L_WARMUP} warm-ups; {len(res['scores'])} boxes in the "
              f"last")
        profiled(f"{what} served frame", lambda: serve(frames[0]),
                 os.path.join(work, f"voxelnet_{encoder}_trace.json"),
                 failures)
        del model
    # 4. HardVFE at the full-width buffer, on hard_voxelize of batch 4
    pts, valid = (torch.cat(a) for a in zip(*[to_batch(cfg32, f, "cpu")
                                              for f in frames[:4]]))
    got = {}
    for dev in (DEVICE, "cpu"):
        t = time.perf_counter()
        scene = extract_scene(cfg32, pts.to(dev), valid.to(dev))
        vox, npts = hard_voxelize(scene, 32)
        enc = HardVFE(cfg.vfe, cfg.voxel, device="meta").to_empty(device=dev)
        init_weights(enc, torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            got[dev] = (vox.cpu(), npts.cpu(), enc(vox, npts,
                                                   scene.table.coords).cpu())
        print(f"  HardVFE on {dev}: voxels {tuple(vox.shape)}, "
              f"{time.perf_counter() - t:.1f} s")
    equal = [torch.equal(a, b)
             for a, b in zip(got[DEVICE][:2], got["cpu"][:2])]
    print(f"  hard_voxelize GPU against CPU: voxels, counts bitwise equal "
          f"{equal}; slots filled {int(got['cpu'][1].sum())} of "
          f"{got['cpu'][1].numel() * 32}")
    if not all(equal):
        failures.append("hard_voxelize differs between the card and the CPU")
    compare("HardVFE (64, 128) f32, batch statistics", got[DEVICE][2],
            got["cpu"][2], *PARITY_TOL, failures)
    return total


def phase_l_point_ops(cfg, failures: list) -> None:
    """The PointNet++ ops, k-medoids and the focal mask on the card
    against the CPU at the sizes their users run."""
    from geomae_tpu_torch.apis import to_batch
    from geomae_tpu_torch.models import mae
    from geomae_tpu_torch.models.detector import extract_scene
    from geomae_tpu_torch.ops import k_medoids as km
    from geomae_tpu_torch.ops import pointnet_ops as pn
    from geomae_tpu_torch.profile_serving import host_ms
    from geomae_tpu_torch.synthetic import clustered_frame

    rng = np.random.default_rng(SEED + 80)
    # an indoor scene's extent (8 x 8 x 3 m), PointNet++'s own setting
    xyz = torch.from_numpy(rng.uniform([0, 0, 0], [8, 8, 3],
                                       (PN_B, PN_N, 3)).astype(np.float32))
    xyz64 = xyz.double()

    def d2(a, b):            # squared distances on the host in f64
        return torch.cdist(a, b) ** 2

    def timed(fn, dev):       # (fn(), its ms on the card, None on the CPU)
        return host_ms(fn) if dev != "cpu" else (fn(), None)

    # furthest point sampling: each card choice at most POINT_TOL short
    # of the best in f64 along its own sequence
    fps = {}
    for dev in (DEVICE, "cpu"):
        out, ms = timed(lambda: pn.furthest_point_sample(xyz.to(dev), PN_S),
                        dev)
        fps[dev] = out.cpu().long()
        if ms is not None:
            print(f"  FPS {PN_N} -> {PN_S} points, batch {PN_B}, on the "
                  f"card: {ms:.2f} ms")
    temp = torch.full((PN_B, PN_N), 1e10, dtype=torch.float64)
    short, near = 0.0, 0
    for i in range(1, PN_S):
        last = fps[DEVICE][:, i - 1]
        p = xyz64[torch.arange(PN_B), last][:, None]
        temp = torch.minimum(temp, ((xyz64 - p) ** 2).sum(-1))
        best = temp.max(1).values
        chosen = temp.gather(1, fps[DEVICE][:, i:i + 1])[:, 0]
        short = max(short, float((best - chosen).max()))
        near += int(((best - chosen) > 0).sum())
    agree = int((fps[DEVICE] == fps["cpu"]).all(1).sum())
    print(f"  FPS: {agree} of {PN_B} sequences equal on both devices; the "
          f"card's choices short of the f64 best by at most {short:.2e} "
          f"m^2 (bound {POINT_TOL:g}), {near} not the f64 argmax")
    if short > POINT_TOL:
        failures.append("FPS chose a point short of the furthest")
    ctr = xyz[torch.arange(PN_B)[:, None], fps["cpu"]]        # [B, S, 3]
    ctr64 = ctr.double()

    # kNN(16) of the centres and three_nn of every point among them
    exact = d2(ctr64, xyz64)
    for what, args, ex in (("knn(16)", (16, xyz, ctr), exact),
                           ("three_nn", (3, ctr, xyz), d2(xyz64, ctr64))):
        res = {}
        for dev in (DEVICE, "cpu"):
            (d, idx), ms = timed(lambda: pn.knn(
                args[0], args[1].to(dev), args[2].to(dev)), dev)
            res[dev] = (d.cpu(), idx.cpu())
            if ms is not None:
                print(f"  {what} on the card: {ms:.2f} ms")
        # squared: a root near 0 turns the product's rounding into mm
        compare(f"{what} squared distances", res[DEVICE][0] ** 2,
                res["cpu"][0] ** 2, POINT_TOL, 0.0, failures)
        got = ex.gather(2, res[DEVICE][1])
        want = ex.gather(2, res["cpu"][1])
        differ = (res[DEVICE][1] != res["cpu"][1]).any(-1)
        print(f"  {what}: rows whose indices differ {int(differ.sum())} of "
              f"{differ.numel()}; their f64 squared distances apart by at "
              f"most {float((got - want).abs().max()):.2e}")
        if float((got - want).abs().max()) > POINT_TOL:
            failures.append(f"{what} chose other neighbours")

    # ball_query(0, 0.4, 32): indices equal but where a point lies within
    # POINT_TOL of the radius
    r2 = 0.4 ** 2
    res = {}
    for dev in (DEVICE, "cpu"):
        out, ms = timed(lambda: pn.ball_query(0.0, 0.4, 32, xyz.to(dev),
                                              ctr.to(dev)), dev)
        res[dev] = out.cpu()
        if ms is not None:
            print(f"  ball_query(0, 0.4, 32) on the card: {ms:.2f} ms")
    differ = (res[DEVICE] != res["cpu"]).any(-1)
    edge = ((exact - r2).abs() < POINT_TOL).any(-1)
    print(f"  ball_query: rows that differ {int(differ.sum())} of "
          f"{differ.numel()}, rows with a point within {POINT_TOL:g} m^2 "
          f"of the radius {int(edge.sum())}; points a ball, median "
          f"{float((res['cpu'] != res['cpu'][..., :1]).sum(-1).median()) + 1}")
    if bool((differ & ~edge).any()):
        failures.append("ball_query differs away from the radius")

    # three_interpolate of 128 channels back to every point, on the CPU's
    # neighbours and weights
    dist, idx = pn.three_nn(xyz, ctr)
    w = 1.0 / (dist + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    feats = torch.from_numpy(rng.normal(size=(PN_B, PN_C, PN_S))
                             .astype(np.float32))
    res = {}
    for dev in (DEVICE, "cpu"):
        out, ms = timed(lambda: pn.three_interpolate(
            feats.to(dev), idx.to(dev), w.to(dev)), dev)
        res[dev] = out.cpu()
        if ms is not None:
            print(f"  three_interpolate [{PN_B}, {PN_C}, {PN_S}] -> "
                  f"{tuple(out.shape)} on the card: {ms:.2f} ms")
    compare("three_interpolate", res[DEVICE], res["cpu"], 1e-5, 1e-5,
            failures)

    # k-medoids of [4, 512, 512] distances into 16 clusters
    pts = torch.from_numpy(rng.normal(size=(PN_B, 512, 3)))
    dist = (pts[:, :, None] - pts[:, None]).norm(dim=-1)
    res = {}
    for dev in (DEVICE, "cpu"):
        out, ms = timed(lambda: km.k_medoids(dist.float().to(dev), 16), dev)
        res[dev] = out.cpu().long()
        if ms is not None:
            print(f"  k_medoids [{PN_B}, 512, 512] -> 16 on the card: "
                  f"{ms:.2f} ms")
    cost = {dev: dist.gather(2, m[:, None, :].expand(PN_B, 512, 16))
            .amin(2).sum(1) for dev, m in res.items()}
    differ = (res[DEVICE] != res["cpu"]).any(1)
    gap = float(((cost[DEVICE] - cost["cpu"]).abs() / cost["cpu"]).max())
    print(f"  k_medoids: batches whose medoids differ {int(differ.sum())} "
          f"of {PN_B}; total distance apart by {gap:.2e} relative")
    if gap > 1e-5:
        failures.append("k_medoids found other clusters")

    # the focal mask on a full-width table, 40 boxes a sample
    frames = [clustered_frame(np.random.default_rng(SEED + 90 + f),
                              cfg.voxel, cfg.caps.max_points)
              for f in range(PN_B)]
    p, v = (torch.cat(a) for a in zip(*[to_batch(cfg, f, "cpu")
                                        for f in frames]))
    r = cfg.voxel.point_cloud_range
    boxes = np.zeros((PN_B, 40, 9), np.float32)
    boxes[..., :2] = rng.uniform(r[0] + 5, r[3] - 5, (PN_B, 40, 2))
    boxes[..., 3:6] = rng.uniform([1.5, 1.5, 1], [6, 3, 3], (PN_B, 40, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (PN_B, 40))
    boxes = torch.from_numpy(boxes)
    gmask = torch.ones((PN_B, 40), dtype=torch.bool)
    u = torch.rand((PN_B, cfg.caps.max_voxels),
                   generator=torch.Generator().manual_seed(SEED))
    res = {}
    for dev in (DEVICE, "cpu"):
        table = extract_scene(cfg, p.to(dev), v.to(dev)).table
        fg = mae.focal_foreground(table, boxes.to(dev), gmask.to(dev),
                                  cfg.voxel)
        keep, ms = timed(lambda: mae.sample_focal_mask(
            torch.Generator(device=dev).manual_seed(SEED), table,
            boxes.to(dev), gmask.to(dev), cfg.voxel, 0.7), dev)
        res[dev] = (table, fg.cpu(), keep.cpu(), mae.focal_keep(
            fg, table.valid, u.to(dev), 0.7).cpu())
        if ms is not None:
            print(f"  sample_focal_mask [{PN_B}, {cfg.caps.max_voxels}], 40 "
                  f"boxes, on the card: {ms:.2f} ms")
    def n_kept(fg, valid):     # floor(n_fg x 0.3) and the background
        return (torch.floor(fg.sum(1).float() * (1.0 - 0.7)).long()
                + (valid & ~fg).sum(1))

    table, fg, keep, on_u = res["cpu"]
    fgd = res[DEVICE][1]
    # a pillar whose test differs must lie within 1e-4 m of a box's edge
    c = table.coords.double()
    pts3 = torch.stack([c[..., 1] * cfg.voxel.voxel_size[0] + r[0],
                        c[..., 0] * cfg.voxel.voxel_size[1] + r[1]], -1)
    b = boxes.double()
    loc = pts3[:, :, None] - b[:, None, :, :2]
    cs, sn = torch.cos(-b[..., 6])[:, None], torch.sin(-b[..., 6])[:, None]
    lx = loc[..., 0] * cs - loc[..., 1] * sn
    ly = loc[..., 0] * sn + loc[..., 1] * cs
    margin = torch.minimum((lx.abs() - b[:, None, :, 3] / 2).abs(),
                           (ly.abs() - b[:, None, :, 4] / 2).abs()).amin(-1)
    differ = fg != fgd
    kd = res[DEVICE][3] != on_u
    n_keep = keep.sum(1)
    want = n_kept(fg, table.valid)
    print(f"  focal mask: foreground pillars {fg.sum(1).tolist()} of "
          f"{table.valid.sum(1).tolist()}; tests that differ "
          f"{int(differ.sum())} (at edges {int((differ & (margin < 1e-4)).sum())}"
          f"); keep masks on shared uniforms differ {int(kd.sum())}; kept "
          f"{n_keep.tolist()}")
    if bool((differ & (margin >= 1e-4)).any()) or (
            not bool(differ.any()) and bool(kd.any())):
        failures.append("the focal mask differs between the card and the CPU")
    if not torch.equal(n_keep, want) or not torch.equal(
            res[DEVICE][2].sum(1), n_kept(fgd, res[DEVICE][0].valid.cpu())):
        failures.append("the focal mask kept the wrong number of pillars")


def phase_l(cfg, wcfg, failures: list, work: str) -> dict:
    """Data preparation, ``VoxelNet`` and the point ops (``phase_l_*``):
    returns the launches of the runs."""
    print(f"phase L: create_data waymo_infos on a raw Waymo tree, then "
          f"the Waymo pretrain ({L_WAYMO_STEPS} steps) and the eval CLI "
          f"from its infos; create_data gt_database on phase J's frames, "
          f"then {L_PASTE_STEPS} fine-tune steps with GT paste; VoxelNet "
          f"with the pillar and the simple encoder at full width; the "
          f"point ops, k-medoids and the focal mask")
    total = phase_l_data(cfg, wcfg, failures, work)
    for k, v in phase_l_voxelnet(cfg, failures, work).items():
        total[k] += v
    phase_l_point_ops(cfg, failures)
    return total


def profiled(what: str, fn, trace: str, failures: list) -> None:
    """One call of ``fn`` under ``torch.profiler``: its wall ms, the
    device's busy ms (union of kernel, copy and memset intervals), the
    idle share and the device operations, printed."""
    from torch.profiler import ProfilerActivity, profile

    from geomae_tpu_torch.profile_serving import DEVICE_CATS, busy_ms, host_ms

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = host_ms(fn)
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if "dur" in e and e.get("cat") in DEVICE_CATS]
    busy = busy_ms((e["ts"], e["ts"] + e["dur"]) for e in events) / 1e3
    print(f"  profiled {what}: wall {wall:.1f} ms, device busy {busy:.2f} "
          f"ms, idle share {1 - busy / wall:.3f}, device ops {len(events)}")
    if not busy:
        failures.append(f"the profiled {what} shows no device time")


def passed(what: str, failures: list, clock: list) -> None:
    """Stop on ``what``'s failures; else print the seconds it took since
    ``clock[0]``, the end of the one before, and restart the clock."""
    if failures:
        raise Failed(f"{what}: {len(failures)} failures, {failures[:5]}")
    now = time.perf_counter()
    print(f"{what} passed in {now - clock[0]:.1f} s")
    clock[0] = now


def main() -> None:
    from geomae_tpu_torch.apis import geomae_finetune_nus
    from geomae_tpu_torch.config import (apply_overrides, geomae_pretrain_nus,
                                         geomae_pretrain_waymo)

    startup()
    cfg = geomae_finetune_nus()
    pcfg = geomae_pretrain_nus()
    dev = torch.device(DEVICE)
    failures: list = []
    results: dict = {}
    clock = [time.perf_counter()]
    phase_a(cfg, "serving", kernel_inputs(cfg, 1, dev), SERVING, results,
            failures)
    passed("phase A (serving shapes)", failures, clock)
    runs = [phase_b(apply_overrides(cfg, [QKV_OPTION]), failures)]
    runs.append(phase_b(apply_overrides(cfg, [BAND_OPTION]), failures))
    passed("phase B", failures, clock)
    phase_c(cfg, failures)
    passed("phase C", failures, clock)
    inputs = kernel_inputs(cfg, cfg.data.batch_size, dev)
    phase_a(cfg, "fine-tune step", inputs, TRAIN, results, failures)
    phase_routes(cfg, inputs, failures)
    del inputs
    wide = apply_overrides(cfg, WIDE_OPTIONS)
    phase_routes(wide, kernel_inputs(wide, wide.data.batch_size, dev),
                 failures)
    passed("phase A (fine-tune step shapes)", failures, clock)
    runs.append(phase_d(apply_overrides(cfg, [QKV_OPTION]), failures))
    runs.append(phase_d(apply_overrides(cfg, [BAND_OPTION]), failures,
                        BAND_REPEAT))
    passed("phase D", failures, clock)
    phase_e(cfg, failures)
    passed("phase E", failures, clock)
    phase_a(pcfg, "pretrain step", pretrain_inputs(pcfg, dev), PRETRAIN,
            results, failures)
    passed("phase A (pretrain step shapes)", failures, clock)
    widths = phase_widths(pcfg, failures)
    passed("phase A (K8, K6, K7 and K5 at every width)", failures, clock)
    runs.append(phase_f(apply_overrides(pcfg, [QKV_OPTION]), failures))
    runs.append(phase_f(apply_overrides(pcfg, [BAND_OPTION]), failures,
                        BAND_REPEAT))
    passed("phase F", failures, clock)
    phase_g(pcfg, failures)
    passed("phase G", failures, clock)
    runs.append(phase_m(pcfg, cfg, failures))
    runs.append(phase_m(pcfg, cfg, failures, QKV_OPTION))
    passed("phase M", failures, clock)
    runs.append(phase_n(pcfg, cfg, failures))
    passed("phase N", failures, clock)
    runs.append(phase_o(pcfg, cfg, failures))
    passed("phase O", failures, clock)
    runs.append(phase_p(pcfg, cfg, failures))
    passed("phase P", failures, clock)
    runs.append(phase_h(pcfg, cfg, failures))
    passed("phase H", failures, clock)
    runs.append(phase_i(pcfg, failures))
    passed("phase I", failures, clock)
    wcfg = geomae_pretrain_waymo()
    phase_a(wcfg, "Waymo pretrain step", pretrain_inputs(wcfg, dev), WAYMO,
            {}, failures)
    passed("phase A (Waymo pretrain step shapes)", failures, clock)
    work = tempfile.mkdtemp(prefix="geomae_smoke_disk_")
    try:
        runs.append(phase_j(pcfg, cfg, wcfg, failures, work))
        passed("phase J", failures, clock)
        runs.append(phase_k(cfg, failures, work))
        passed("phase K", failures, clock)
        runs.append(phase_l(cfg, wcfg, failures, work))
        passed("phase L", failures, clock)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rows = results[name]
        t_bytes, t_ops = sum(r[3] for r in rows), sum(r[4] for r in rows)
        libs = [r[5] for r in rows if r[5] is not None]
        # K8's, K6's, K7's, their projections' and K5's entries also name
        # the widths phase A ran them at
        at = {"widths": [w["width"] for w in widths if w["name"] == name]} \
            if name.startswith(("band_attention", "qkv_project",
                                "post_attention")) else {}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(r[name] for r in runs),
            max_abs_err=max(r[0] for r in rows),
            ms=sum(r[1] for r in rows),
            plain_ms=sum(r[2] for r in rows),
            bound_ms=sum(max(r[3], r[4]) for r in rows),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=sum(libs) if libs else None, **at))
    print(json.dumps({"widths": widths}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
