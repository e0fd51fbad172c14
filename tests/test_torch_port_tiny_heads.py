"""K8's plain versions at the head widths below 8: d_model 128 in 32
heads of 4, 64 of 2 and 128 of 1, and 384 in 64 heads of 6 and 128 of 3
(the smallest head count that gives each width), against the JAX package
on the CPU (K6 / K7: ``test_torch_port_tiny_heads_qkv_*.py``; one SST
block: ``test_torch_port_tiny_heads_block.py``; so that each file stays
under 40 s alone).

The width gate admits the widths, and every attention name resolves to
a kernel route there.  K8 (``ops/attention.py``): the plain forward
against the JAX einsum route (``geomae_tpu/ops/attention.py:
band_attention``) in f32 and bf16, its statistics against the
log-sum-exp of that route's masked, scaled f32 scores, and the plain
backward against the vjp of that route in f32 on the same values (JAX's
own K8 forward in interpret mode traces its 32 to 128 heads one by one,
and its backward takes at most 10 heads, R6); the bf16 kernels' plain
twins (``band_attention_tiles_plain``, the forward's 64-token tiles and
64-key chunks, and ``band_attention_backward_tiles_plain`` at the
kernel's 64-token tiles and 64-row chunks) against the plain versions on
windows of 1 to 300 tokens, at each width in 16 heads (both compute each
head alone, so the head count only multiplies the work: at 128 heads the
plain versions' 1,024-query blocks over those windows took 22 s); the D
prologue's twin against the JAX einsum.  The bf16 kernels run these
heads over 8-channel slots whose channels past D are zero; the twins
keep the kernels' order over the head's own channels (zeros change no
sum).

Tolerances: f32 2e-5 + 2e-4 relative, the statistics 1e-5; bf16 2e-2 +
2e-2 relative with atol times each row's max(1, largest |ref|) (the JAX
route also rounds its probabilities before their sum, the port after:
each moves a term by at most 2^-9 of itself); the tile twins against the
plain versions in f32 at 1e-5 of the largest value (the same terms
summed in another order), the bf16 forward twin at the bf16 rule (p
rounded against another max); the prologue at (D - 1) 2^-24 sum |terms|
(D exact f32 products added in another order; 0 at D = 1)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomae_tpu.ops.attention import band_attention as jax_einsum
from geomae_tpu_torch.models.sst import attention_route
from geomae_tpu_torch.ops import attention, attention_qkv
from test_torch_port_band_ops import (DTYPES, assert_rows_close, make_case,
                                      sized_windows, to_torch)

INT_MAX = np.iinfo(np.int32).max
# (C, heads): D 4, 2, 1 at C 128; D 6, 3 at C 384
TINY = [(128, 32), (128, 64), (128, 128), (384, 64), (384, 128)]
IDS = [f"{c}in{h}" for c, h in TINY]
TILE = 64
TWIN_HEADS = 16           # heads of the tile twins' cases


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def einsum_case(H, D, dtype):
    """One sample of 128 window-sorted tokens at (H, D) with a window
    whose keys are all invalid and a cotangent zero on the padding rows;
    the JAX einsum route's output in ``dtype``, the log-sum-exp of its
    masked, scaled f32 scores per (row, head) (0 where a row sees no
    key), and the vjp of the route in f32 on the same values (dq, dk,
    dv), in one compiled call.  (torch inputs, JAX outputs), once a
    width and dtype for the file."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, win, kv = make_case(np.random.default_rng(20 + D + H), B=1,
                                 V=128, H=H, D=D)
    kv[0, win[0] == win[0, 0]] = False          # a window without a key
    real = (win != INT_MAX)[..., None, None]
    g = (np.random.default_rng(2).normal(size=q.shape) * real).astype(
        np.float32)
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    jw, jkv = jnp.asarray(win), jnp.asarray(kv)

    def forward_backward(q, k, v, w, kv, g):
        out = jax_einsum(q, k, v, w, kv, TILE)
        f32 = [t.astype(jnp.float32) for t in (q, k, v)]
        s = jnp.einsum("bqhd,bkhd->bhqk", f32[0], f32[1]) / D ** 0.5
        mask = ((w[:, :, None] == w[:, None, :]) & kv[:, None, :])[:, None]
        seen = mask.any(-1)
        lse = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
        lse = jnp.where(seen, lse, 0.0).transpose(0, 2, 1)   # [B, V, H]
        _, vjp = jax.vjp(lambda *x: jax_einsum(*x, w, kv, TILE), *f32)
        return out, lse, vjp(g.astype(jnp.float32))

    out, lse, grads = jax.jit(forward_backward)(jq, jk, jv, jw, jkv, jg)
    torch_in = (*(to_torch(a, tdt) for a in (jq, jk, jv)),
                torch.from_numpy(win), torch.from_numpy(kv),
                to_torch(jg, tdt))
    return torch_in, (out, np.asarray(lse), grads)


@pytest.mark.parametrize("C,H", TINY, ids=IDS)
def test_tiny_heads_take_the_kernels(C, H):
    """The width gate admits every width, and every attention name
    resolves to a kernel route there; the bf16 backward takes 64-row
    chunks; the f32 K6 / K7 lanes keep whole heads (8 channels of heads
    of 1, 2 and 4, 12 of heads of 3 and 6), so a tile holds D 8's or D
    12's tokens; the same head width at C 768 stays outside."""
    D = C // H
    assert attention.kernel_takes(C, H) and (C, D) in \
        attention.kernel_widths()
    assert attention_qkv.kernel_takes(C, H)
    assert [attention_route(i, C, H) for i in ("auto", "band", "qkv")] \
        == ["band", "band", "qkv"]
    assert attention.backward_chunk(D) == attention.KERNEL_TILE
    assert attention_qkv.f32_lane_channels(D) == D
    assert attention_qkv.f32_lane_heads(D) * D == (12 if D % 3 == 0 else 8)
    assert attention_qkv.f32_tile(C, H) == attention_qkv.f32_tile(
        C, C // (12 if D % 3 == 0 else 8))
    assert not attention.kernel_takes(768, 768 // D)
    assert attention_route("band", 768, 768 // D) == "einsum"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", TINY, ids=IDS)
def test_k8_forward_and_statistics_at_tiny_heads(C, H, dtype):
    """The plain forward against the JAX einsum route on the real rows,
    padding rows 0; the statistics (from the inputs in f32) against the
    log-sum-exp of the route's scores at 1e-5 where a row sees a key, 0
    elsewhere."""
    (tq, tk, tv, tw, tkv, _), (want, want_lse, _) = einsum_case(
        H, C // H, dtype)
    assert tq.shape[2:] == (H, C // H)
    got = attention.band_attention(tq, tk, tv, tw, tkv)
    assert got.dtype == DTYPES[dtype][1]
    real = (tw != INT_MAX).numpy()
    assert_rows_close(got.float().numpy()[real],
                      np.asarray(want.astype(jnp.float32))[real], dtype)
    assert (got.float().numpy()[~real] == 0).all()
    lse = attention.band_attention_lse_plain(tq, tk, tw, tkv).numpy()
    seen = want_lse != 0
    assert seen.any() and (~seen & real[..., None]).any()
    np.testing.assert_allclose(lse[seen], want_lse[seen], rtol=0, atol=1e-5)
    assert (lse[~seen] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,H", TINY, ids=IDS)
def test_k8_backward_at_tiny_heads(C, H, dtype):
    """The plain backward against the vjp of the JAX einsum route in f32
    on the same values, with a window whose keys are all invalid, per
    row; padding rows 0."""
    (tq, tk, tv, tw, tkv, tg), (_, _, want) = einsum_case(H, C // H, dtype)
    out = attention.band_attention(tq, tk, tv, tw, tkv)
    got = attention.band_attention_backward_plain(tq, tk, tv, tw, tkv, out,
                                                  tg)
    pad = (tw[0] == INT_MAX).numpy()
    for a, w in zip(got, want):
        assert a.dtype == DTYPES[dtype][1] and a.shape[2:] == (H, C // H)
        a = a.float().numpy()
        assert_rows_close(a.reshape(*a.shape[:2], -1),
                          np.asarray(w.astype(jnp.float32)).reshape(
                              *a.shape[:2], -1), dtype)
        assert pad.any() and (a[0, pad] == 0).all()


@pytest.mark.parametrize("C,H", TINY, ids=IDS)
def test_k8_tile_twins_at_tiny_heads(C, H):
    """The bf16 kernels' orders in plain PyTorch, at the width's D in 16
    heads, on windows of 1 to 300 tokens (one of them without a valid
    key): the forward twin against
    ``band_attention`` in f32 and in bf16, its lse against
    ``band_attention_lse_plain`` at 1e-5 where a row sees a key; the
    backward twin at the kernel's tiling (64-token tiles as queries and
    keys, 64-row chunks) against the plain backward in f32; padding rows
    and the keyless window's dq 0."""
    q, k, v, win, kv, g, keyless = sized_windows(
        np.random.default_rng(C + H), H=TWIN_HEADS, D=C // H)
    t = torch.from_numpy
    lse, plain = {}, {}
    for dtype in DTYPES:
        tdt = DTYPES[dtype][1]
        args = [t(a).to(tdt) for a in (q, k, v)] + [t(win), t(kv)]
        out, lse[dtype] = attention.band_attention_tiles_plain(*args)
        plain[dtype] = attention.band_attention(*args)
        assert out.dtype == tdt
        assert_rows_close(out.float().flatten(2).numpy(),
                          plain[dtype].float().flatten(2).numpy(), dtype)
    lse = lse["f32"]
    args = [t(a) for a in (q, k, v, win, kv)]
    want_lse = attention.band_attention_lse_plain(args[0], args[1],
                                                  *args[3:])
    seen = want_lse != 0
    torch.testing.assert_close(lse[seen], want_lse[seen], rtol=0, atol=1e-5)
    assert (lse[~seen] == 0).all()
    out = plain["f32"]
    got = attention.band_attention_backward_tiles_plain(*args, out, want_lse,
                                                        t(g))
    want = attention.band_attention_backward_plain(*args, out, t(g))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    pad = t(win == INT_MAX)
    assert pad.any() and all((a[pad] == 0).all() for a in got)
    assert (got[0][t(keyless)] == 0).all()


@pytest.mark.parametrize("C,H", TINY, ids=IDS)
def test_k8_delta_at_tiny_heads(C, H):
    """D = rowsum(g * out) per (row, head) on bf16 inputs against the JAX
    package's ``einsum(..., preferred_element_type=f32)``: every product
    is exact in f32, so only the order of D f32 additions differs (none
    at D = 1); 0 on the padding rows."""
    D = C // H
    rng = np.random.default_rng(C + D)
    g, out = (rng.normal(size=(2, 200, H, D)).astype(np.float32)
              for _ in range(2))
    jg, jo = (jnp.asarray(a, jnp.bfloat16) for a in (g, out))
    want = np.asarray(jnp.einsum("bvhd,bvhd->bvh", jg, jo,
                                 preferred_element_type=jnp.float32))
    tg, to = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
              for a in (jg, jo))
    win = torch.zeros(2, 200, dtype=torch.int32)
    win[1, 120:] = INT_MAX                   # a padding suffix
    real = (win != INT_MAX).numpy()
    got = attention.band_attention_delta_plain(to, tg, win)
    assert got.dtype == torch.float32 and got.shape == want.shape
    mag = attention.band_attention_delta_plain(to.abs(), tg.abs(),
                                               win).numpy()
    err = np.abs(got.numpy() - want)
    assert (err[real] <= (D - 1) * 2.0 ** -24 * mag[real]).all()
    assert (got.numpy()[~real] == 0).all() and (mag[real] > 0).all()

