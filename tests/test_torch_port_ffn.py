"""K5 post_attention_block: the port's plain version (what the CUDA kernel
is held to) against the Pallas kernel in interpret mode and the XLA chain
of models/sst.EncoderLayer.

Tolerance 1e-5: f32 matmuls over 128 / 256 channels in another order and
LayerNorm statistics over 128.  Rows at or past ``nv`` are 0 in the port;
the Pallas kernel zeroes whole tiles past ``nv`` and computes the rest of
the tile holding ``nv``, so only rows before ``nv`` and the skipped tiles
are compared against it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomae_tpu.ops.pallas_ffn import post_attention_block as jax_block
from geomae_tpu_torch import probe_k5_backward
from geomae_tpu_torch.ops.ffn import (
    KERNEL_WIDTHS, post_attention_block, post_attention_block_backward_plain,
    post_attention_block_backward_tile_plain, post_attention_block_plain,
    weight_grads_plain)
from test_pallas_ffn import ORDER, make_case, ref_block

TILE = 64


def port(x, attn, ws, nv=None):
    t = lambda a: torch.from_numpy(np.array(a))
    return post_attention_block(
        t(x), t(attn), *[t(ws[k][0]) for k in ORDER],
        None if nv is None else t(nv)).numpy()


def test_matches_pallas_interpret_with_short_extent():
    x, attn, ws = make_case(np.random.default_rng(0), B=2, V=256)
    nv = np.array([100, 256], np.int32)
    got = port(x, attn, ws, nv)
    want = np.asarray(jax_block(x, attn, *[ws[k] for k in ORDER],
                                jnp.asarray(nv), 1e-5, TILE, True))
    rows = np.arange(256)
    before = rows[None, :] < nv[:, None]
    skipped = rows[None, :] >= -(-nv[:, None] // TILE) * TILE
    np.testing.assert_allclose(got[before], want[before], rtol=1e-5,
                               atol=1e-5)
    assert skipped.any() and (want[skipped] == 0).all()
    assert (got[~before] == 0).all()


def test_bf16_matches_pallas_interpret_with_short_extent():
    """The plain version in bfloat16 (what the bf16 kernel is held to on
    the card) against the Pallas kernel in interpret mode in bfloat16, on
    the same values: 2e-2 + 2e-2 relative per row (atol times the row's
    max(1, largest |ref|)): both round at the same points, but f32 sums in
    another order may move a rounding to the other side.  Rows past
    ``nv`` are exactly 0 in the port, the tiles past ``nv`` in both."""
    x, attn, ws = make_case(np.random.default_rng(4), B=2, V=256,
                            dtype=jnp.bfloat16)
    nv = np.array([100, 256], np.int32)
    bf = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))
                                    ).bfloat16()
    got = post_attention_block_plain(
        bf(x), bf(attn), *[torch.from_numpy(np.array(ws[k][0]))
                           for k in ORDER], torch.from_numpy(nv))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.array(jax_block(x, attn, *[ws[k] for k in ORDER],
                              jnp.asarray(nv), 1e-5, TILE, True
                              ).astype(jnp.float32))
    rows = np.arange(256)
    before = rows[None, :] < nv[:, None]
    skipped = rows[None, :] >= -(-nv[:, None] // TILE) * TILE
    g, w = got[before], want[before]
    bound = 2e-2 * np.maximum(np.abs(w).max(-1, keepdims=True), 1) \
        + 2e-2 * np.abs(w)
    assert (np.abs(g - w) <= bound).all()
    assert skipped.any() and (want[skipped] == 0).all()
    assert (got[~before] == 0).all()


def test_matches_xla_chain():
    x, attn, ws = make_case(np.random.default_rng(1), B=2, V=128)
    got = port(x, attn, ws)
    want = np.asarray(ref_block(x, attn, *[ws[k] for k in ORDER]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_wrapper_dispatch():
    x, attn, ws = make_case(np.random.default_rng(2), B=1, V=128)
    t = lambda a: torch.from_numpy(np.array(a))
    args = (t(x), t(attn), *[t(ws[k][0]) for k in ORDER])
    assert torch.equal(post_attention_block(*args),
                       post_attention_block_plain(*args))
    with pytest.raises(ValueError):
        post_attention_block(*[a.to("meta") for a in args])


@pytest.mark.parametrize("B,V,nv", [(1, 70, (70,)), (3, 96, (96, 0, 41))])
def test_backward_twins_compose_to_the_plain_backward(B, V, nv):
    """The bf16 backward's two passes as plain twins: the per-tile pass
    and the weight-gradient pass, composed on a padded batch whose attn
    rows past ``nv`` hold NaN, against each sample's real rows alone (no
    padding, ``nv`` None), summed over the samples.  f32 at 1e-6 relative
    to each output's largest value: the same products over other row
    counts may sum in another order.  The padded rows of dx, dattn and
    the workspace rows are exactly 0."""
    rng = np.random.default_rng(3)
    C, F = 32, 64
    r = lambda *s, scale=0.3: torch.from_numpy(
        (rng.normal(size=s) * scale).astype(np.float32))
    x, attn, dy = r(B, V, C, scale=1.0), r(B, V, C, scale=1.0), \
        r(B, V, C, scale=1.0)
    ws = [r(C, C), r(C), 1 + r(C, scale=0.1), r(C, scale=0.1), r(C, F),
          r(F), r(F, C), r(C), 1 + r(C, scale=0.1), r(C, scale=0.1)]
    nv_t = torch.tensor(nv, dtype=torch.int32)
    keep = torch.arange(V)[None, :] < nv_t[:, None]
    attn = torch.where(keep[..., None], attn, float("nan"))
    tile = post_attention_block_backward_tile_plain(x, attn, *ws, nv_t, dy)
    for t in tile[:6]:                  # dx, dattn, xm, da1, h, dz2
        assert (t[~keep] == 0).all()
    wgrads = weight_grads_plain(attn, tile[0], *tile[2:6], nv_t)
    dbo, ds1, dt1, db1, db2, ds2, dt2 = tile[6:]
    got = (*tile[:2], wgrads[0], dbo, ds1, dt1, wgrads[1], db1, wgrads[2],
           db2, ds2, dt2)
    assert all(torch.isfinite(t).all() for t in got)
    assert all(torch.equal(a, b) for a, b in zip(
        got, post_attention_block_backward_plain(x, attn, *ws, nv_t, dy)))
    within = lambda a, w: torch.testing.assert_close(
        a, w, rtol=0, atol=1e-6 * float(w.abs().max()))
    want = [torch.zeros_like(g) for g in got[2:]]
    for b, n in enumerate(nv):
        if n == 0:
            continue
        one = lambda t: t[b:b + 1, :n]
        part = post_attention_block_backward_plain(
            one(x), one(attn), *ws, None, one(dy))
        within(got[0][b:b + 1, :n], part[0])
        within(got[1][b:b + 1, :n], part[1])
        want = [w + p for w, p in zip(want, part[2:])]
    for a, w in zip(got[2:], want):
        within(a, w)


@pytest.mark.parametrize("C,F", KERNEL_WIDTHS,
                         ids=[f"{c}-{f}" for c, f in KERNEL_WIDTHS])
def test_gradient_rule_holds_the_plain_version_and_fails_a_dropped_token(
        C, F):
    """F5's rule for K5's ten bf16 parameter gradients
    (``probe_k5_backward.grad_bounds``: (2^-8 + n 2^-24) sum |terms| per
    element, against the plain backward with f64 values and sums at the
    same bf16 rounding points), on the ``cuda`` tests' one-sample case
    (seed 5, V 777, nv 500): the plain bf16 backward here holds to it,
    and the same backward with one token's terms dropped (its cotangent
    zeroed, ``dropped_token``) breaks it in every one of the ten."""
    args = probe_k5_backward.test_case(C, F, 1, 777, (500,))
    exact = probe_k5_backward.f64_grads(args)
    bounds = probe_k5_backward.grad_bounds(args)
    got = post_attention_block_backward_plain(*args)[2:]
    fault = post_attention_block_backward_plain(
        *probe_k5_backward.dropped_token(args))[2:]
    ok = probe_k5_backward.rule_shares(got, exact, bounds)
    broken = probe_k5_backward.rule_shares(fault, exact, bounds)
    assert all(s <= 1 for s in ok), ok
    assert all(s > 1 for s in broken), broken
