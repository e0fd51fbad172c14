"""The SST kernels' plain versions at every width the kernels take, and
the wide detector, against the JAX package on the CPU.

K8 (``ops/attention.py``) at (H, D) = (8, 32), (4, 32) and (2, 64): the
plain forward, its statistics and the plain backward against
``band_attention_pallas`` and its backward in interpret mode; K5
(``ops/ffn.py``) at (C, F) = (256, 512) and (128, 512): the plain forward
and backward against ``post_attention_block`` in interpret mode, V = 128.
f32 at the shipped width's rules (K8: 2e-5 + 2e-4 relative, the
statistics 1e-5; K5: 1e-5, its gradients 1e-5 of each one's largest
value); bf16 at 2e-2 + 2e-2 relative, atol times each row's max(1,
largest |ref|) (both round at the same points; f32 sums in another order
may move a rounding to the other side).  One SST block at C = 256 in 8
heads of 32 on the band / fused route against the JAX stack's Pallas
routes in interpret mode; the route table at every width of the sets
(K8, K6 and K5 at C 128, 256, 384 and 512, C 384 in heads of 12, 24,
48, 96 and 192, C 256 and 512 in heads of 256 and C 384 and 512 in one
head among them) and at nine widths outside them (heads of 3, 4 and 1,
F of 8 C, of 320 and of 2,048 at C 256, C 384 in heads of 6, F of 5 C
at C 512, C 640), beside JAX's own decision; and F4:
the tiny fine-tune step at width 256 (``vfe.feat_channels=16,256
sst.d_model=256 sst.nhead=8 sst.dim_feedforward=512``), where SECOND
takes the SST's width, against the JAX step, from flax variables on the shapes of the JAX init
(``jax.eval_shape``, drawn with numpy as the VoxelNet tests draw them:
compiling the init took a third of this file's time).  The JAX
interpret-mode results are computed once for the file and shared by the
tests that read them (``k8_case``; K5's in
``test_torch_port_ffn_widths.k5_case``, whose checks this file shares),
the JAX stack's layouts and init compiled
(``test_torch_port_band_ops.jax_shift``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomae_tpu.config import SSTConfig as JaxSSTConfig
from geomae_tpu.config import apply_overrides as jax_overrides
from geomae_tpu.config import tiny_finetune_config
from geomae_tpu.models import sst as jax_sst
from geomae_tpu.ops.pallas_attention import _pallas_backward as jax_band_bwd
from geomae_tpu.ops.pallas_attention import _pallas_forward as jax_band_fwd
from geomae_tpu_torch.config import SSTConfig
from geomae_tpu_torch.models.detector import DynamicVoxelNet
from geomae_tpu_torch.models.sst import SSTStack
from geomae_tpu_torch.ops import attention
from test_torch_port_band_ops import (DTYPES, assert_rows_close,
                                      check_route_against_pallas, make_case,
                                      stack_case, to_torch)
from test_torch_port_ffn_widths import check_k5_backward, check_k5_forward
from test_torch_port_train_step import (JFT, JaxNet, check_gradients,
                                        check_losses, jax_and_port_step)
from test_torch_port_voxelnet import random_variables

INT_MAX = np.iinfo(np.int32).max
K8_HEADS = [(8, 32), (4, 32), (2, 64)]
K5_WIDTHS = [(256, 512), (128, 512)]
WIDE = ["vfe.feat_channels=16,256", "sst.d_model=256", "sst.nhead=8",
        "sst.dim_feedforward=512"]
TILE = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def k8_case(H, D, dtype):
    """One sample of 128 window-sorted tokens at (H, D) with a window
    whose keys are all invalid, a cotangent zero on the padding rows, and
    the interpret-mode kernel's forward (out, statistics) and backward
    (dq, dk, dv) on them: (torch inputs, JAX outputs); each width's JAX
    results once for the file, in one compiled call."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, win, kv = make_case(np.random.default_rng(20 + D + H), B=1,
                                 V=128, H=H, D=D)
    kv[0, win[0] == win[0, 0]] = False          # a window without a key
    real = (win != INT_MAX)[..., None, None]
    g = (np.random.default_rng(2).normal(size=q.shape) * real).astype(
        np.float32)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jw, jkv = jnp.asarray(win), jnp.asarray(kv)

    def forward_backward(*a):
        out, stats = jax_band_fwd(*a[:5], TILE, 128, True)
        return out, stats, jax_band_bwd(*a[:5], out, stats, a[5], TILE, 128,
                                        True)

    out, stats, grads = jax.jit(forward_backward)(jq, jk, jv, jw, jkv, jg)
    torch_in = (*(to_torch(a, tdt) for a in (jq, jk, jv)),
                torch.from_numpy(win), torch.from_numpy(kv),
                to_torch(jg, tdt))
    return torch_in, (out, np.asarray(stats), grads)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,D", K8_HEADS)
def test_k8_forward_and_statistics_at_width(H, D, dtype):
    """The plain forward against ``_pallas_forward`` in interpret mode on
    the real rows, padding rows 0; f32 statistics (m + log l where a row
    sees a key) at 1e-5, 0 elsewhere."""
    (tq, tk, tv, tw, tkv, _), (want, stats, _) = k8_case(H, D, dtype)
    got = attention.band_attention(tq, tk, tv, tw, tkv)
    assert got.dtype == DTYPES[dtype][1]
    real = (tw != INT_MAX).numpy()
    assert_rows_close(got.float().numpy()[real],
                      np.asarray(want.astype(jnp.float32))[real], dtype)
    assert (got.float().numpy()[~real] == 0).all()
    if dtype == "f32":
        m, l = stats[..., :H], stats[..., H:]
        lse = attention.band_attention_lse_plain(tq, tk, tw, tkv).numpy()
        seen = l > 0
        assert seen.any() and (~seen & real[..., None]).any()
        np.testing.assert_allclose(
            lse[seen], (m + np.log(np.where(seen, l, 1)))[seen], rtol=0,
            atol=1e-5)
        assert (lse[~seen] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,D", K8_HEADS)
def test_k8_backward_at_width(H, D, dtype):
    """The plain backward against the interpret-mode ``_pallas_backward``
    from the kernel's own forward, with a window whose keys are all
    invalid; padding rows 0."""
    (tq, tk, tv, tw, tkv, tg), (_, _, want) = k8_case(H, D, dtype)
    out = attention.band_attention(tq, tk, tv, tw, tkv)
    got = attention.band_attention_backward_plain(tq, tk, tv, tw, tkv, out,
                                                  tg)
    pad = (tw[0] == INT_MAX).numpy()
    for a, w in zip(got, want):
        assert a.dtype == DTYPES[dtype][1]
        a = a.float().numpy()
        assert_rows_close(a.reshape(*a.shape[:2], -1),
                          np.asarray(w.astype(jnp.float32)).reshape(
                              *a.shape[:2], -1), dtype)
        assert pad.any() and (a[0, pad] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,F", K5_WIDTHS)
def test_k5_forward_at_width(C, F, dtype):
    """``check_k5_forward`` at F of 2 C and 4 C."""
    check_k5_forward(C, F, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,F", K5_WIDTHS)
def test_k5_backward_at_width(C, F, dtype):
    """``check_k5_backward`` at F of 2 C and 4 C."""
    check_k5_backward(C, F, dtype)


def test_sst_block_at_256_matches_the_jax_pallas_routes():
    """One block at C = 256 in 8 heads of 32, FFN 512, V = 128, on the
    port's band / fused route (K8, K5: their plain versions here) against
    the JAX stack's band / fused route in interpret mode, 1e-4 on the
    valid rows."""
    check_route_against_pallas(stack_case((256, 8, 512), V=128,
                                          grads=False))


# (C, heads) K8 is written for, (C, heads) K6 / K7 are and (C, F) K5 is,
# stated apart from the gates under test: K8 and K6 / K7 C 128, 256, 384
# or 512 in heads of 1, 2, 4, 8, 16, 32, 64 or 128 channels, C 384 in
# heads of 3, 6, 12, 24, 48, 96 or 192 (the only C of the four they
# divide), C 256 and 512 in heads of 256, C 384 and 512 in one head, and
# C 640, 768 and 1024 in heads of 8, 16, 32, 64 or 128; K5 F of 1, 2, 3 or
# 4 times C at C 128, 256, 384, 512, 640, 768 or 1024
HEAD_DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256,
             384, 512)
WIDE_HEAD_DIMS = (8, 16, 32, 64, 128)
ATTENTION_KERNEL_WIDTHS = {(C, C // D) for C in (128, 256, 384, 512)
                           for D in HEAD_DIMS if C % D == 0} | {
    (C, C // D) for C in (640, 768, 1024) for D in WIDE_HEAD_DIMS}
QKV_KERNEL_WIDTHS = {(C, C // D) for C in (128, 256, 384, 512)
                     for D in HEAD_DIMS if C % D == 0} | {
    (C, C // D) for C in (640, 768, 1024) for D in WIDE_HEAD_DIMS}
FFN_KERNEL_WIDTHS = {(C, k * C) for C in (128, 256, 384, 512, 640, 768, 1024)
                     for k in (1, 2, 3, 4)}
WIDTHS = [(C, C // D, F) for C in (128, 256, 384, 512) for D in HEAD_DIMS
          for F in (C, 2 * C, 3 * C, 4 * C)
          if C % D == 0 and (C, F) in FFN_KERNEL_WIDTHS] + [
    (C, C // D, k * C) for C in (640, 768, 1024) for D in WIDE_HEAD_DIMS
    for k in (1, 2, 3, 4)]
# widths outside the sets: F of 8 C; F not a multiple of 128; F of 2,048
# at C 256; F of 5 C at C 512; C 640 in 160 heads of 4 and in 128 of 5;
# C 768 in 64 heads of 12, in 3 of 256 and in one head; C 1024 in 256
# heads of 4 and with F of 8 C; C 1152 in 18 heads of 64
OUTSIDE = [(128, 8, 1024), (128, 8, 320), (256, 8, 2048), (512, 8, 2560),
           (640, 160, 1280), (640, 128, 1280), (768, 64, 1536),
           (768, 3, 1536), (768, 1, 1536), (1024, 256, 2048),
           (1024, 16, 8192), (1152, 18, 2304)]


def routes(sst):
    """(attention route, ffn route) of an SST stack's first layer, built
    on the meta device (its weights are not read)."""
    layer = SSTStack(sst, 1, device="meta")[0].encoder_list[0]
    return layer.win_attn.route, "fused" if layer.fused else "xla"


def jax_routes(jc, V=128):
    """The JAX stack's decision for explicitly named routes: the kernel
    routes where its gates hold (C a multiple of 128, V of 128)."""
    C = jc.d_model
    sel = jax_sst._select_attention(jc.attention_impl)
    attn = "einsum" if sel is None or C % 128 or V % 128 else sel[0]
    return attn, "fused" if jax_sst._use_fused_ffn(jc, V, C) else "xla"


@pytest.mark.parametrize("width", WIDTHS + OUTSIDE,
                         ids=lambda w: "-".join(map(str, w)))
def test_route_resolution_at_widths(width):
    """At every width of the sets (C of 128, 256, 384 or 512 in heads of
    D of 1, 2, 4, 8, 16, 32, 64 or 128, C 384 in 128 heads of 3, 64 of
    6, 32 of 12, 16 of 24, 8 of 48, 4 of 96 or 2 of 192, C 256 in one
    head of 256 and 512 in two, C 384 and 512 in one head, C 640, 768
    and 1024 in heads of 8 to 128, F of 1, 2, 3 or 4 times C) "band",
    "fused" and "auto" resolve to the kernels (K8, K5; "auto" to K8), and
    "qkv" to K6 at every C, 640, 768 and 1024 among them; JAX resolves
    "band", "qkv" / "fused" to its kernels
    throughout, heads narrower than 8 among them.  At F of 8 C, of 320,
    of 2,048 at C 256 and of 2,560 at C 512 the port's FFN takes the
    unfused chain under every name (its attention, of a width K8 takes,
    the kernel), JAX its kernel; at C 640 in heads of 4 and 5, 768 in
    heads of 12, 256 and 768 and 1024 in heads of 4 the port's attention
    takes the plain route under every name, and at C 1152 both its
    routes do, JAX its kernels: widths the port serves on the plain
    routes."""
    d_model, nhead, dim_ff = width
    attn_in = (d_model, nhead) in ATTENTION_KERNEL_WIDTHS
    qkv_in = (d_model, nhead) in QKV_KERNEL_WIDTHS
    ffn_in = (d_model, dim_ff) in FFN_KERNEL_WIDTHS
    for impl in ("band", "qkv", "einsum", "auto"):
        for ffn_impl in ("fused", "xla", "auto"):
            kw = dict(d_model=d_model, nhead=nhead, dim_feedforward=dim_ff,
                      attention_impl=impl, ffn_impl=ffn_impl)
            want_attn = {"band": "band", "auto": "band", "einsum": "einsum",
                         "qkv": "qkv" if qkv_in else "einsum"}[impl] \
                if attn_in else "einsum"
            want_ffn = "xla" if ffn_impl == "xla" or not ffn_in else "fused"
            assert routes(SSTConfig(**kw)) == (want_attn, want_ffn), kw
            if "auto" not in (impl, ffn_impl):   # JAX: by its backend
                # JAX keeps the named kernel at every C a multiple of 128
                assert jax_routes(JaxSSTConfig(**kw)) == (impl, ffn_impl)


@pytest.fixture(scope="module")
def wide_step():
    cfg = jax_overrides(tiny_finetune_config(), WIDE)
    batch = JFT.dummy_batch(cfg, 1)
    scene = jax.jit(lambda p, v: JFT.extract_scene(cfg, p, v))(
        batch["points"], batch["point_valid"])
    var = random_variables(JaxNet(cfg), scene)
    return jax_and_port_step(cfg, (var["params"], var["batch_stats"]))


def test_wide_detector_loads_the_jax_init(wide_step):
    """F4: at width 256 the port's detector takes ``from_flax`` of flax
    variables of the JAX init's tree strictly (in ``jax_and_port_step``),
    SECOND's first convolution reading the SST's 256 channels (flax infers
    them; ``cfg.second.in_channels`` stays 32), on the kernels' routes."""
    assert wide_step.cfg.second.in_channels == 32
    model = DynamicVoxelNet(wide_step.cfg)
    model.load_state_dict(wide_step.before, strict=True)
    conv = model.backbone.conv_blocks[0][0]
    assert conv.weight.shape[1] == 256
    layer = model.backbone.encoder_blocks[0].encoder_list[0]
    assert (layer.win_attn.route, layer.fused) == ("band", True)


def test_wide_step_losses_match_jax(wide_step):
    check_losses(wide_step)


def test_wide_step_gradients_match_jax(wide_step):
    check_gradients(wide_step)
