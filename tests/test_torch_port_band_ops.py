"""K8 (window attention over projected q, k, v) and the SST routes in the
port against the JAX package, f32, on the CPU: the plain forward, its
statistics and the plain backward (what the CUDA kernels are held to)
against ``band_attention_pallas`` in interpret mode and against autograd
of the plain forward; a window wider than the TPU band against the einsum
route; one ``SSTStack`` at the shipped width on every attention and FFN
route against the JAX stack from the same carried weights; and the weight
mapping of the JAX band route's three Dense projections.  The bf16
backward kernel's decomposition (``band_attention_backward_tiles_plain``:
64-token tiles as queries and as keys over exact key ranges, D from
``band_attention_delta_plain``) against the plain backward, against
``_pallas_backward`` in interpret mode on windows of 1 to 300 tokens, and
the delta against the JAX einsum on bf16 inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from geomae_tpu.config import SSTConfig as JaxSSTConfig
from geomae_tpu.config import VoxelConfig as JaxVoxelConfig
from geomae_tpu.models.sst import SSTStack as JaxSST
from geomae_tpu.models.sst import prepare_shift_data as jax_shift_data
from geomae_tpu.ops import windows as jwin
from geomae_tpu.ops.attention import band_attention as jax_band_attention
from geomae_tpu.ops.pallas_attention import _pallas_backward as jax_band_bwd
from geomae_tpu.ops.pallas_attention import _pallas_forward as jax_band_fwd
from geomae_tpu.ops.pallas_attention import band_attention_pallas
from geomae_tpu_torch.config import SSTConfig, VoxelConfig
from geomae_tpu_torch.models.sst import SSTStack, prepare_shift_data
from geomae_tpu_torch.ops import attention, windows
from geomae_tpu_torch.weights import from_flax

INT_MAX = np.iinfo(np.int32).max
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def to_torch(a, dtype=torch.float32):
    """A JAX or numpy array as a torch tensor of ``dtype`` (bf16 values
    carried exactly through f32)."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))
                            ).to(dtype)


def assert_rows_close(got, want, dtype, atol=2e-5, rtol=2e-4):
    """f32 at (atol, rtol); bf16 at 2e-2 + 2e-2 relative with atol times
    each row's max(1, largest |want|) (the last axis a row)."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(g).all()
    if dtype == "f32":
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
        return
    bound = 2e-2 * np.maximum(np.abs(w).max(-1, keepdims=True), 1) \
        + 2e-2 * np.abs(w)
    assert (np.abs(g - w) <= bound).all(), float((np.abs(g - w) / bound).max())


t = torch.from_numpy


def make_case(rng, B=2, V=256, H=4, D=8, win_size=5):
    """The cases of ``tests/test_pallas_attention.py``: sorted window ids
    with variable occupancy, an INT32_MAX tail, 30 % invalid keys."""
    q, k, v = (rng.normal(size=(B, V, H, D)).astype(np.float32)
               for _ in range(3))
    win = np.full((B, V), INT_MAX, np.int32)
    for b in range(B):
        n_valid = int(rng.integers(V // 2, V))
        ids, w = [], 0
        while len(ids) < n_valid:
            ids.extend([w] * int(rng.integers(1, win_size + 1)))
            w += 1
        win[b, :n_valid] = ids[:n_valid]
    kv = (rng.random((B, V)) > 0.3) & (win != INT_MAX)
    return q, k, v, win, kv


def pallas(q, k, v, win, kv):
    return band_attention_pallas(q, k, v, jnp.asarray(win), jnp.asarray(kv),
                                 tile=64, pad=128, interpret=True)


@pytest.mark.parametrize("shape", [dict(), dict(B=1, V=128, H=2),
                                   dict(B=1, V=256, H=2, win_size=40)])
def test_forward_and_statistics_match_pallas(shape):
    """Output at 2e-5 + 2e-4 relative on the real rows (the JAX test's own
    bound against its einsum route), padding rows exactly 0; statistics:
    the kernel's m + log l on rows with a valid key at 1e-5 (f32
    exponentials summed in another order), 0 elsewhere."""
    q, k, v, win, kv = make_case(np.random.default_rng(0), **shape)
    kv[0, win[0] == win[0, 0]] = False          # a window without a key
    want, stats = jax_band_fwd(*map(jnp.asarray, (q, k, v, win, kv)), 64,
                               128, True)
    got = attention.band_attention(t(q), t(k), t(v), t(win), t(kv)).numpy()
    real = win != INT_MAX
    np.testing.assert_allclose(got[real], np.asarray(want)[real], rtol=2e-4,
                               atol=2e-5)
    assert (got[~real] == 0).all() and (got[0, 0] == 0).all()
    H = q.shape[2]
    stats = np.asarray(stats)
    m, l = stats[..., :H], stats[..., H:]
    lse = attention.band_attention_lse_plain(t(q), t(k), t(win),
                                             t(kv)).numpy()
    seen = l > 0
    assert seen.any() and (~seen & real[..., None]).any()
    np.testing.assert_allclose(
        lse[seen], (m + np.log(np.where(seen, l, 1)))[seen], rtol=0,
        atol=1e-5)
    assert (lse[~seen] == 0).all()


def plain_grads(q, k, v, win, kv, g):
    """(dq, dk, dv) of the plain backward for the cotangent g, and the
    same through autograd of the plain forward."""
    leaves = [t(a.copy()).requires_grad_() for a in (q, k, v)]
    out = attention.band_attention(*leaves, t(win), t(kv))
    auto = torch.autograd.grad(out, leaves, t(g))
    plain = attention.band_attention_backward_plain(
        t(q), t(k), t(v), t(win), t(kv), out.detach(), t(g))
    return [a.numpy() for a in plain], [a.numpy() for a in auto]


@pytest.mark.parametrize("empty_window", [False, True])
def test_backward_matches_pallas_and_autograd(empty_window):
    """The plain backward, written from the kernel's formulas, against
    ``jax.grad`` of the interpret-mode kernel (2e-5 + 2e-4 relative, the
    JAX test's bound) and against autograd of the plain forward (1e-5 of
    the largest value: the same sums in another order).  With a window
    whose keys are all invalid: its rows' dq exactly 0, everything
    finite."""
    q, k, v, win, kv = make_case(np.random.default_rng(1), B=1, V=128, H=2)
    if empty_window:
        kv[0, win[0] == win[0, 0]] = False
    real = (win != INT_MAX)[..., None, None]
    g = (np.random.default_rng(2).normal(size=q.shape) * real).astype(
        np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(pallas(q_, k_, v_, win, kv) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    plain, auto = plain_grads(q, k, v, win, kv, g)
    for a, b, w in zip(plain, auto, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(w), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    if empty_window:
        rows = win[0] == win[0, 0]
        assert (plain[0][0, rows] == 0).all()
        assert (np.asarray(want[0])[0, rows] == 0).all()
    pad = win[0] == INT_MAX
    assert pad.any() and all((a[0, pad] == 0).all() for a in plain)


def test_wide_window_matches_the_einsum_route():
    """Windows of up to 300 tokens, wider than the TPU kernel's +-192
    band: forward and backward against the JAX einsum ``band_attention``
    with a band wide enough to be exact (tile 128, 3 bands).  Forward
    1e-5; gradients 2e-5 of the largest value."""
    rng = np.random.default_rng(3)
    q, k, v, win, kv = make_case(rng, B=2, V=1024, H=2, D=16, win_size=300)
    assert max(np.bincount(w[w != INT_MAX]).max() for w in win) > 192
    g = (rng.normal(size=q.shape) * (win != INT_MAX)[..., None, None]
         ).astype(np.float32)

    def fwd(q_, k_, v_):
        return jax_band_attention(q_, k_, v_, jnp.asarray(win),
                                  jnp.asarray(kv), 128, 3)

    jq = tuple(map(jnp.asarray, (q, k, v)))
    want = np.asarray(fwd(*jq))
    want_g = jax.grad(lambda *a: jnp.sum(fwd(*a) * g), argnums=(0, 1, 2))(*jq)
    got = attention.band_attention(t(q), t(k), t(v), t(win), t(kv)).numpy()
    real = win != INT_MAX
    np.testing.assert_allclose(got[real], want[real], rtol=1e-5, atol=1e-5)
    plain, _ = plain_grads(q, k, v, win, kv, g)
    for a, w in zip(plain, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(a, w, rtol=0, atol=2e-5 * np.abs(w).max())


def test_fused_wrapper_takes_the_plain_versions_on_the_cpu():
    """On CPU tensors the K8 wrapper is the plain forward and, under grad,
    the plain backward (an ``autograd.Function``); a tensor on another
    device than CPU or CUDA is refused."""
    q, k, v, win, kv = make_case(np.random.default_rng(4))
    args = (t(q), t(k), t(v), t(win), t(kv))
    assert torch.equal(attention.band_attention_fused(*args),
                       attention.band_attention(*args))
    leaves = [a.clone().requires_grad_() for a in args[:3]]
    out = attention.band_attention_fused(*leaves, *args[3:])
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, leaves, g)
    want = attention.band_attention_backward_plain(*args, out.detach(), g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        attention.band_attention_fused(*[a.to("meta") for a in args])


# ---------------------------------------------------------------------------
# the bf16 backward kernel's decomposition
# ---------------------------------------------------------------------------

WINDOW_SIZES = (1, 63, 64, 65, 20, 144, 300)    # the 20-token one: no key


def sized_windows(rng, H=2, D=8, V=768):
    """Two samples of windows of 1, 63, 64, 65, 144 and 300 tokens and one
    of 20 tokens whose keys are all invalid (in order, then reversed),
    20 % of the other keys invalid, an INT32_MAX tail; q, k, v and a
    cotangent that is 0 on the tail; the keyless window's rows."""
    win = np.full((2, V), INT_MAX, np.int32)
    kv = rng.random((2, V)) > 0.2
    keyless = np.zeros((2, V), bool)
    for b, sizes in enumerate((WINDOW_SIZES, WINDOW_SIZES[::-1])):
        r = 0
        for w, n in enumerate(sizes):
            win[b, r:r + n] = 3 * w
            keyless[b, r:r + n] = n == 20
            r += n
    kv &= (win != INT_MAX) & ~keyless
    q, k, v = (rng.normal(size=(2, V, H, D)).astype(np.float32)
               for _ in range(3))
    g = (rng.normal(size=q.shape) * (win != INT_MAX)[..., None, None]
         ).astype(np.float32)
    return q, k, v, win, kv, g, keyless


def tiles_plain(q, k, v, win, kv, g, **tiling):
    """(dq, dk, dv) of the kernel's decomposition from the plain forward's
    output and statistics, with the plain backward's (dq, dk, dv)."""
    args = (t(q), t(k), t(v), t(win), t(kv))
    out = attention.band_attention(*args)
    lse = attention.band_attention_lse_plain(args[0], args[1], *args[3:])
    got = attention.band_attention_backward_tiles_plain(*args, out, lse, t(g),
                                                        **tiling)
    want = attention.band_attention_backward_plain(*args, out, t(g))
    return got, want


@pytest.mark.parametrize("case,tiling", [
    ("random", dict()), ("random", dict(tile=32, chunk=16)),
    ("sizes", dict()), ("sizes", dict(tile=16, chunk=64))])
def test_tiled_backward_matches_the_plain_backward(case, tiling):
    """The decomposition against the plain backward in f32 (1e-5 of the
    largest value: the same terms summed in another order), on the
    Pallas tests' random layout and on windows of 1 to 300 tokens; every
    row of the keyless window and of the tail exactly 0 in dq, and the
    tail 0 in dk and dv."""
    rng = np.random.default_rng(12)
    if case == "random":
        q, k, v, win, kv = make_case(rng, B=2, V=300, H=2, D=8, win_size=90)
        g = (rng.normal(size=q.shape) * (win != INT_MAX)[..., None, None]
             ).astype(np.float32)
    else:
        q, k, v, win, kv, g, keyless = sized_windows(rng)
    got, want = tiles_plain(q, k, v, win, kv, g, **tiling)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    pad = t(win == INT_MAX)
    assert pad.any() and all((a[pad] == 0).all() for a in got)
    if case == "sizes":
        assert (got[0][t(keyless)] == 0).all()


def test_tiled_backward_matches_pallas_on_window_sizes():
    """The decomposition against ``_pallas_backward`` in interpret mode
    with a band wide enough for 300-token windows (tile 128, pad 320),
    from the Pallas forward's output and statistics: 2e-5 + 2e-4
    relative (the JAX test's bound); dq of the keyless window 0 in both."""
    q, k, v, win, kv, g, keyless = sized_windows(np.random.default_rng(13))
    jargs = tuple(map(jnp.asarray, (q, k, v, win, kv)))
    out, stats = jax_band_fwd(*jargs, 128, 320, True)
    want = jax_band_bwd(*jargs, out, stats, jnp.asarray(g), 128, 320, True)
    args = (t(q), t(k), t(v), t(win), t(kv))
    lse = attention.band_attention_lse_plain(args[0], args[1], *args[3:])
    got = attention.band_attention_backward_tiles_plain(
        *args, t(np.array(out)), lse, t(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)
    assert (got[0].numpy()[keyless] == 0).all()
    assert (np.asarray(want[0])[keyless] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_forward_matches_the_plain_forward_and_pallas(dtype):
    """The bf16 forward kernel's order (``band_attention_tiles_plain``:
    64-token tiles over exact key ranges, an online softmax per 64-key
    chunk, p rounded to v's dtype against the running max) on windows of
    1 to 300 tokens, against ``band_attention`` and against
    ``band_attention_pallas`` in interpret mode (tile 128, pad 320), on the
    same values: f32 at 2e-5 + 2e-4 relative (the file's bound); bf16 at
    2e-2 + 2e-2 relative per row (atol times the row's max(1, largest
    |ref|)), where p is rounded against another max.  Its lse against
    ``band_attention_lse_plain`` at 1e-5 on the rows that see a key,
    exactly 0 elsewhere; the padding rows and the keyless window's rows
    are 0."""
    q, k, v, win, kv, _, keyless = sized_windows(np.random.default_rng(15))
    tdt = getattr(torch, dtype)
    args = [t(a).to(tdt) for a in (q, k, v)] + [t(win), t(kv)]
    out, lse = attention.band_attention_tiles_plain(*args)
    assert out.dtype == tdt and lse.dtype == torch.float32
    jq = [jnp.asarray(a.float().numpy()).astype(dtype) for a in args[:3]]
    pal = band_attention_pallas(*jq, jnp.asarray(win), jnp.asarray(kv),
                                tile=128, pad=320, interpret=True)
    pal = t(np.array(pal.astype(jnp.float32)))
    atol, rtol = (2e-5, 2e-4) if dtype == "float32" else (2e-2, 2e-2)
    got = out.float().flatten(2)
    for want in (attention.band_attention(*args), pal):
        w = want.float().flatten(2)
        scale = (1.0 if dtype == "float32"
                 else w.abs().amax(-1, keepdim=True).clamp_min(1))
        assert ((got - w).abs() <= atol * scale + rtol * w.abs()).all()
    real = win != INT_MAX
    seen = np.zeros_like(real)
    for b in range(win.shape[0]):
        for w_id in np.unique(win[b][real[b]]):
            rows = win[b] == w_id
            seen[b, rows] = kv[b, rows].any()
    assert (~seen & real).any() and (~seen[keyless]).all()
    want = attention.band_attention_lse_plain(args[0], args[1], *args[3:])
    torch.testing.assert_close(lse[t(seen)], want[t(seen)], rtol=0,
                               atol=1e-5)
    assert (lse[t(~seen)] == 0).all() and (out[t(~seen)] == 0).all()


def test_delta_matches_the_jax_einsum_in_bf16():
    """D = rowsum(g * out) per (row, head) on bf16 inputs against the JAX
    package's ``einsum(..., preferred_element_type=f32)``: every product
    is exact in f32, so only the order of 16 f32 additions differs (at
    most 15 x 2^-24 x sum |terms|); 0 on the padding rows."""
    rng = np.random.default_rng(14)
    g, out = (rng.normal(size=(2, 200, 8, 16)).astype(np.float32)
              for _ in range(2))
    jg, jo = (jnp.asarray(a, jnp.bfloat16) for a in (g, out))
    want = np.asarray(jnp.einsum("bvhd,bvhd->bvh", jg, jo,
                                 preferred_element_type=jnp.float32))
    tg, to = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
              for a in (jg, jo))
    win = torch.zeros(2, 200, dtype=torch.int32)
    win[0, 150:] = INT_MAX                   # a padding suffix
    real = (win != INT_MAX).numpy()
    got = attention.band_attention_delta_plain(to, tg, win)
    assert got.dtype == torch.float32 and got.shape == want.shape
    mag = attention.band_attention_delta_plain(to.abs(), tg.abs(),
                                               win).numpy()
    err = np.abs(got.numpy() - want)
    assert (err[real] <= 15 * 2.0 ** -24 * mag[real]).all()
    assert (got.numpy()[~real] == 0).all() and (mag[real] > 0).all()


# ---------------------------------------------------------------------------
# the SST routes
# ---------------------------------------------------------------------------

B, V, C = 2, 384, 128
ROUTES = [(a, f) for a in ("qkv", "band", "einsum") for f in ("fused", "xla")]


SHIPPED = (C, 8, 256)     # (d_model, nhead, dim_feedforward)


def sst_cfgs(attention_impl="einsum", ffn_impl="xla", width=SHIPPED):
    d_model, nhead, dim_feedforward = width
    kw = dict(d_model=d_model, nhead=nhead, dim_feedforward=dim_feedforward,
              attention_impl=attention_impl, ffn_impl=ffn_impl)
    return JaxSSTConfig(**kw), SSTConfig(**kw)


def jax_shift(coords, valid, jc):
    """The JAX stack's shift data of ``coords`` and ``valid`` (numpy) at
    config ``jc``, compiled (eagerly the layouts take seconds a call)."""
    return jax.jit(lambda c, v: jax_shift_data(
        jwin.make_layouts(c, v, jc, JaxVoxelConfig()), None, v, jc,
        JaxVoxelConfig()))(jnp.asarray(coords), jnp.asarray(valid))


def stack_case(width=SHIPPED, V=V, grads=True):
    """Tokens on a 40 x 40 corner of the grid (12 x 12 windows of up to
    about 40 tokens), the JAX stack's output (and with ``grads`` its
    parameter gradients) on its einsum / xla route, and the same weights
    in the port's names, at ``width``."""
    rng = np.random.default_rng(5)
    jc, _ = sst_cfgs(width=width)
    Cw = width[0]
    cells = np.stack([rng.choice(1600, V, replace=False) for _ in range(B)])
    coords = np.stack([np.zeros_like(cells), cells // 40, cells % 40],
                      -1).astype(np.int32)
    valid = np.arange(V)[None] < np.array([[V - 37], [V - 90]])
    x = rng.normal(0, 0.5, (B, V, Cw)).astype(np.float32)
    w = (rng.normal(size=(B, V, Cw)) * valid[..., None]).astype(np.float32)
    shift = jax_shift(coords, valid, jc)
    net = JaxSST(jc, 1, jnp.float32)
    params = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                               shift)["params"]
    # biases and norm parameters away from their 0 / 1 init
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a if p[-1].key == "kernel" else
        a + rng.normal(0, 0.1, a.shape).astype(np.float32), params)
    strip = lambda sd: {k[len("backbone.encoder_blocks."):]: v
                        for k, v in sd.items()}
    case = dict(coords=coords, valid=valid, x=x, w=w, params=params,
                width=width, sd=strip(from_flax({"encoder": params}, {})))
    if not grads:
        return case

    def loss(p):
        out = net.apply({"params": p}, jnp.asarray(x), shift)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return dict(case, out=np.asarray(out),
                grads=strip(from_flax({"encoder": grads}, {})))


@pytest.fixture(scope="module")
def stack():
    return stack_case()


@pytest.mark.parametrize("attention_impl,ffn_impl", ROUTES)
def test_sst_routes_match_the_jax_stack(stack, attention_impl, ffn_impl):
    """One block (two layers) at C = 128, V = 384 on each route, from one
    ``state_dict``: the output on valid rows at 1e-4 (two post-norm layers
    in f32, sums over 128 channels in other orders) and every parameter
    gradient at 1e-4 relative norm, against the JAX einsum / xla route."""
    _, tc = sst_cfgs(attention_impl, ffn_impl)
    model = SSTStack(tc, 1)
    model.load_state_dict(stack["sd"], strict=True)
    tv = t(stack["valid"])
    shift = prepare_shift_data(
        windows.make_layouts(t(stack["coords"]), tv, tc, VoxelConfig()), tv,
        tc)
    out = model(t(stack["x"]), shift)
    (out * t(stack["w"])).sum().backward()
    v = stack["valid"]
    np.testing.assert_allclose(out.detach().numpy()[v], stack["out"][v],
                               rtol=1e-4, atol=1e-4)
    grads = dict(model.named_parameters())
    assert grads.keys() == stack["grads"].keys()
    for k, want in stack["grads"].items():
        err = float((grads[k].grad - want).norm() / want.norm())
        assert err <= 1e-4, (k, err)


def test_band_route_matches_the_jax_pallas_routes(stack):
    """The port's band / fused block against the JAX stack on its own
    band / fused route, the Pallas kernels in interpret mode: 1e-4 on
    valid rows."""
    check_route_against_pallas(stack)


def check_route_against_pallas(stack, route="band"):
    """``stack_case``'s block on the port's ``route`` (band or qkv) /
    fused route against the JAX stack on the same routes in interpret
    mode, at 1e-4 on the valid rows; the port's routes resolve to its
    kernels' (K8 or K6, and K5)."""
    jc, tc = sst_cfgs(route, "fused", stack["width"])
    shift = jax_shift(stack["coords"], stack["valid"], jc)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(JaxSST(jc, 1, jnp.float32).apply)(
            {"params": stack["params"]}, jnp.asarray(stack["x"]), shift))
    model = SSTStack(tc, 1)
    layer = model[0].encoder_list[0]
    assert (layer.win_attn.route, layer.fused) == (route, True)
    model.load_state_dict(stack["sd"], strict=True)
    tv = t(stack["valid"])
    tshift = prepare_shift_data(
        windows.make_layouts(t(stack["coords"]), tv, tc, VoxelConfig()), tv,
        tc)
    with torch.no_grad():
        got = model(t(stack["x"]), tshift).numpy()
    v = stack["valid"]
    np.testing.assert_allclose(got[v], want[v], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("field,value", [("attention_impl", "flash"),
                                         ("ffn_impl", "fast"),
                                         ("activation", "silu")])
def test_unknown_route_raises(field, value):
    with pytest.raises(ValueError, match=field):
        SSTStack(SSTConfig(**{field: value}), 1)


def test_relu_takes_the_unfused_chain():
    """``activation="relu"`` runs the unfused chain under any ``ffn_impl``
    (the fused block is GELU only), as in the JAX package."""
    layer = SSTStack(SSTConfig(activation="relu", ffn_impl="fused"), 1)[0]
    assert not layer.encoder_list[0].fused
    assert SSTStack(SSTConfig(), 1)[0].encoder_list[0].fused


def routes(sst):
    """(attention route, ffn route) of an SST stack's first layer."""
    layer = SSTStack(sst, 1)[0].encoder_list[0]
    return layer.win_attn.route, "fused" if layer.fused else "xla"


@pytest.mark.parametrize("impl", ["auto", "qkv", "band", "pallas",
                                  "einsum"])
@pytest.mark.parametrize("ffn_impl", ["auto", "fused", "xla"])
def test_route_resolution(impl, ffn_impl):
    """The whole table of ``attention_route`` / ``ffn_route``: the tiny
    presets (32 in 4 heads, FFN 64) take the plain routes under every
    name; at the kernels' widths "auto" is band / fused, "qkv" stays qkv,
    "pallas" is band; ReLU takes the unfused chain."""
    from geomae_tpu_torch.config import (tiny_finetune_config,
                                         tiny_pretrain_config)
    for tiny in (tiny_pretrain_config(), tiny_finetune_config()):
        sst = dataclasses.replace(tiny.sst, attention_impl=impl,
                                  ffn_impl=ffn_impl)
        assert routes(sst) == ("einsum", "xla")
    full = {"auto": "band", "qkv": "qkv", "band": "band", "pallas": "band",
            "einsum": "einsum"}[impl]
    sst = SSTConfig(attention_impl=impl, ffn_impl=ffn_impl)
    assert routes(sst) == (full, "xla" if ffn_impl == "xla" else "fused")
    relu = dataclasses.replace(sst, activation="relu")
    assert routes(relu) == (full, "xla")


def test_band_route_projections_map_onto_in_proj(stack):
    """The JAX stack declares the same parameter tree on its qkv, band and
    einsum routes (shapes from ``jax.eval_shape``), and ``from_flax`` puts
    the three Dense kernels of the band route into ``in_proj_weight`` rows
    q, k, v, transposed, as it does for the qkv route's."""
    x = jax.ShapeDtypeStruct((B, 384, C), jnp.float32)
    jc, _ = sst_cfgs()
    shift = jax_shift(stack["coords"], stack["valid"], jc)
    trees = {}
    for impl in ("qkv", "band", "einsum"):
        net = JaxSST(sst_cfgs(impl, "fused")[0], 1, jnp.float32)
        shapes = jax.eval_shape(
            lambda: net.init(jax.random.PRNGKey(0), x, shift))["params"]
        trees[impl] = {jax.tree_util.keystr(p): a.shape for p, a in
                       jax.tree_util.tree_leaves_with_path(shapes)}
    assert trees["band"] == trees["qkv"] == trees["einsum"]
    attn = stack["params"]["blocks"]["block"]["encoder_0"]["win_attn"]
    got = stack["sd"]["0.encoder_list.0.win_attn.self_attn.in_proj_weight"]
    want = np.concatenate([np.asarray(attn[n]["kernel"])[0].T
                           for n in ("q_proj", "k_proj", "v_proj")])
    assert np.array_equal(got.numpy(), want)
