"""K6 band_attention_qkv: the port's plain version (what the CUDA kernel
is held to) against the Pallas kernel in interpret mode and against XLA
projections + the einsum band_attention of the JAX package; and the bf16
kernels' decomposition (the projections' plain version ``qkv_project_plain``,
then K8's plain ``band_attention``) against the plain K6 and the Pallas
kernel.

B=2, V=512, C=128, 8 heads of 16, window-sorted tokens with a padding
suffix and key_valid-false rows.  Tolerance 1e-5: f32 projections over
128 channels and softmax sums over at most 40 keys, in other orders."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geomae_tpu.ops.attention import band_attention as jax_band_attention
from geomae_tpu.ops.pallas_attention_qkv import band_attention_qkv as jax_qkv
from geomae_tpu_torch.ops.attention import (band_attention,
                                            band_attention_lse_plain)
from geomae_tpu_torch.ops.attention_qkv import (band_attention_qkv,
                                                band_attention_qkv_lse_plain,
                                                band_attention_qkv_plain,
                                                qkv_project, qkv_project_plain)

INT_MAX = np.iinfo(np.int32).max
B, V, C, H = 2, 512, 128, 8


def make_case(rng, win_size=40, V=V):
    x = rng.normal(size=(B, V, C)).astype(np.float32)
    pos = rng.normal(size=(B, V, C)).astype(np.float32)
    win = np.full((B, V), INT_MAX, np.int32)
    for b in range(B):
        n_valid = int(rng.integers(V // 2, V - 64))
        ids, w = [], 0
        while len(ids) < n_valid:
            ids.extend([w] * int(rng.integers(1, win_size + 1)))
            w += 2
        win[b, :n_valid] = ids[:n_valid]
    kv = (rng.random((B, V)) > 0.3) & (win != INT_MAX)
    ws = []
    for _ in range(3):
        ws.append((rng.normal(size=(C, C)) / np.sqrt(C)).astype(np.float32))
        ws.append((rng.normal(size=(C,)) * 0.1).astype(np.float32))
    return x, pos, win, kv, ws


def port(x, pos, win, kv, ws):
    t = torch.from_numpy
    return band_attention_qkv(t(x), t(pos), *map(t, ws), t(win), t(kv),
                              H).numpy()


def test_matches_pallas_interpret():
    x, pos, win, kv, ws = make_case(np.random.default_rng(0))
    got = port(x, pos, win, kv, ws)
    j = [jnp.asarray(w)[None] for w in ws]
    want = np.asarray(jax_qkv(jnp.asarray(x), jnp.asarray(pos), *j,
                              jnp.asarray(win), jnp.asarray(kv), H, 128, 192,
                              True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # padding rows and rows whose window has no valid key are exactly 0
    empty = win == INT_MAX
    for b in range(B):
        for w in np.unique(win[b][~empty[b]]):
            if not kv[b][win[b] == w].any():
                empty[b] |= win[b] == w
    assert empty.any() and (got[empty] == 0).all()


def test_matches_xla_projections_and_einsum():
    x, pos, win, kv, ws = make_case(np.random.default_rng(1))
    got = port(x, pos, win, kv, ws)
    wq, bq, wk, bk, wv, bv = map(jnp.asarray, ws)
    xj, pj = jnp.asarray(x), jnp.asarray(pos)
    q = ((xj + pj) @ wq + bq).reshape(B, V, H, C // H)
    k = ((xj + pj) @ wk + bk).reshape(B, V, H, C // H)
    v = (xj @ wv + bv).reshape(B, V, H, C // H)
    want = np.asarray(jax_band_attention(q, k, v, jnp.asarray(win),
                                         jnp.asarray(kv))).reshape(B, V, C)
    real = win != INT_MAX
    np.testing.assert_allclose(got[real], want[real], rtol=1e-5, atol=1e-5)


def test_windows_wider_than_the_tpu_band():
    """Windows of up to 400 tokens (the TPU band holds 144): the plain
    version takes each window's full key range; checked against a dense
    masked softmax in numpy."""
    rng = np.random.default_rng(2)
    x, pos, win, kv, ws = make_case(rng, win_size=400)
    got = port(x, pos, win, kv, ws)
    D = C // H
    q = ((x + pos) @ ws[0] + ws[1]).reshape(B, V, H, D) * D ** -0.5
    k = ((x + pos) @ ws[2] + ws[3]).reshape(B, V, H, D)
    v = (x @ ws[4] + ws[5]).reshape(B, V, H, D)
    assert max(np.bincount(w[w != INT_MAX]).max() for w in win) > 144
    for b in range(B):
        mask = (win[b][:, None] == win[b][None, :]) & kv[b][None, :]
        mask &= (win[b] != INT_MAX)[:, None]
        s = np.einsum("qhd,khd->hqk", q[b], k[b], dtype=np.float64)
        s = np.where(mask, s, -np.inf)
        m = np.where(mask.any(-1), s.max(-1), 0)
        p = np.where(mask, np.exp(s - m[..., None]), 0)
        o = np.einsum("hqk,khd->qhd", p, v[b]) / np.maximum(
            p.sum(-1), 1e-30).T[..., None]
        np.testing.assert_allclose(got[b], o.reshape(V, C), rtol=1e-5,
                                   atol=1e-5)


def test_plain_band_attention_chunks_agree():
    """Query chunks that split windows give the same rows as one chunk."""
    x, pos, win, kv, ws = make_case(np.random.default_rng(3))
    t = torch.from_numpy
    q, k, v = (t(a).reshape(B, V, H, C // H) for a in (x, pos, x))
    whole = band_attention(q, k, v, t(win), t(kv))
    split = band_attention(q, k, v, t(win), t(kv), q_chunk=37)
    torch.testing.assert_close(split, whole, rtol=1e-6, atol=1e-6)


def test_wrapper_dispatch():
    x, pos, win, kv, ws = make_case(np.random.default_rng(4))
    t = torch.from_numpy
    args = (t(x), t(pos), *map(t, ws), t(win), t(kv), H)
    assert torch.equal(band_attention_qkv(*args),
                       band_attention_qkv_plain(*args))
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError):
        band_attention_qkv(*meta)


def composed(x, pos, ws, win, kv):
    """The bf16 kernels' order in plain PyTorch: the projections, then K8
    (the 1/sqrt(D) scale on the f32 score, where K6 folds it into q):
    (out [B, V, C], lse [B, V, H])."""
    q, k, v = (t.reshape(B, V, H, C // H)
               for t in qkv_project_plain(x, pos, *ws, win))
    return (band_attention(q, k, v, win, kv).reshape(B, V, C),
            band_attention_lse_plain(q, k, win, kv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_projections_then_band_attention_are_the_plain_k6(dtype):
    """The decomposition equals ``band_attention_qkv_plain`` and its
    statistics bitwise: 0.25 is a power of two, so folding it into q (in
    either dtype) or scaling the f32 score by it gives the same score.
    The projections are 0 on padding rows."""
    x, pos, win, kv, ws = make_case(np.random.default_rng(5))
    t = lambda a: torch.from_numpy(a)
    args = (t(x).to(dtype), t(pos), *map(t, ws), t(win), t(kv))
    out, lse = composed(*args[:2], args[2:8], *args[8:])
    assert torch.equal(out, band_attention_qkv_plain(*args, H))
    assert torch.equal(lse, band_attention_qkv_lse_plain(*args, H))
    pad = t(win) == INT_MAX
    assert all((p[pad] == 0).all()
               for p in qkv_project_plain(*args[:8], t(win)))
    assert torch.equal(qkv_project(*args[:8], t(win))[0],
                       qkv_project_plain(*args[:8], t(win))[0])


def test_projections_then_band_attention_match_pallas_interpret():
    """The decomposition in f32 against the Pallas kernel in interpret
    mode, at ``test_matches_pallas_interpret``'s 1e-5."""
    x, pos, win, kv, ws = make_case(np.random.default_rng(6))
    t = torch.from_numpy
    got = composed(t(x), t(pos), list(map(t, ws)), t(win), t(kv))[0]
    j = [jnp.asarray(w)[None] for w in ws]
    want = np.asarray(jax_qkv(jnp.asarray(x), jnp.asarray(pos), *j,
                              jnp.asarray(win), jnp.asarray(kv), H, 128, 192,
                              True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
