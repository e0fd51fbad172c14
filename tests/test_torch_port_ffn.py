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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops, as the tier-1 run puts
    six test processes on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("f5", ["F5 as it is", "F5 off"])
@pytest.mark.parametrize("C,F", [(128, 256), (384, 768)])
def test_phase_a_gradient_rules_hold_the_plain_version_and_fail_a_dropped_tile(
        C, F, f5, monkeypatch):
    """``chip_smoke.compare_grads`` on K5's bf16 backward (the ten
    parameter gradients against the plain version at K5_GRAD_TOL of C,
    F5's rule alongside, and the planted faults of K5_FAULT_ROWS, each of
    which must break a rule): the plain backward held to itself passes,
    the faults it plants included; the same backward with a dropped
    16-token tile (``dropped_token(args, 16)``) fails.  Both hold with
    F5's bounds made infinite too: the kernel-against-plain rule sees the
    faults on its own, as it must at phase A's token counts, where F5's
    bound grows past a tile's terms."""
    import chip_smoke

    if f5 == "F5 off":
        monkeypatch.setattr(probe_k5_backward, "grad_bounds", lambda a: [
            torch.full_like(g, float("inf"))
            for g in probe_k5_backward.f64_grads(a)])
    args = probe_k5_backward.test_case(C, F, 2, 300, (300, 211))
    want = post_attention_block_backward_plain(*args)
    fault = post_attention_block_backward_plain(
        *probe_k5_backward.dropped_token(args, 16))
    for got, failed in ((want, False), (fault, True)):
        failures = []
        chip_smoke.compare_grads(
            "K5", "post_attention_block_backward", (*want[:2], *got[2:]),
            want, torch.bfloat16, (2e-2, 2e-2), failures, args)
        assert bool(failures) == failed, failures


@pytest.mark.parametrize("C,F", [(384, 768), (512, 2048)])
def test_phase_a_precision_rule_fails_gradients_rounded_to_bf16(C, F):
    """Rule (3) of ``chip_smoke.K5_GRAD_TOL``'s comment
    (``probe_k5_backward.low_bits_shares``): the plain bf16 backward's ten
    f32 parameter gradients end in LOW_BITS zero bits in at most
    LOW_BITS_SHARE of their elements, at 511, 500 and 3,548 tokens, the
    same gradients rounded to bf16 in all of them; ``compare_grads`` fails
    the rounded ones by that rule (and passes the plain version, its
    planted faults each breaking a rule, the rounding among them)."""
    import chip_smoke

    k5 = probe_k5_backward
    for B, V, nv in ((1, 777, (500,)), (2, 2048, (2048, 1500))):
        grads = post_attention_block_backward_plain(
            *k5.test_case(C, F, B, V, nv))[2:]
        assert max(k5.low_bits_shares(grads)) <= k5.LOW_BITS_SHARE
    args = k5.test_case(C, F, 2, 300, (300, 211))
    want = post_attention_block_backward_plain(*args)
    rounded = [g.bfloat16().float() for g in want[2:]]
    assert max(k5.low_bits_shares(want[2:])) <= k5.LOW_BITS_SHARE
    assert min(k5.low_bits_shares(rounded)) == 1.0
    for got, failed in ((want[2:], []), (rounded, [
            "K5 kernel: gradients short of f32 precision"])):
        failures = []
        chip_smoke.compare_grads(
            "K5", "post_attention_block_backward", (*want[:2], *got), want,
            torch.bfloat16, (2e-2, 2e-2), failures, args)
        assert [f for f in failures if "precision" in f] == failed, failures


def test_dropped_token_zeroes_an_aligned_tile_of_real_rows():
    """``dropped_token(args, rows)`` zeroes the cotangent of the aligned
    ``rows``-token tile around the first sample's largest |dy|, cut at its
    real rows, and nothing else."""
    args = probe_k5_backward.test_case(128, 256, 2, 50, (37, 50))
    dy = args[13].clone()
    dy[0, 35] = 10.0                     # the largest, in the tile [32, 40)
    args[13] = dy
    for rows, zeroed in ((1, [35]), (8, list(range(32, 37))),
                         (16, list(range(32, 37)))):
        got = probe_k5_backward.dropped_token(args, rows)[13]
        gone = (got != dy).any(-1)
        assert gone[1].sum() == 0
        assert gone[0].nonzero().flatten().tolist() == [
            t for t in zeroed if bool(dy[0, t].ne(0).any())]
        assert (got[0, zeroed] == 0).all()
