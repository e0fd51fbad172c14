"""The port's CUDA kernels against their plain versions, on a CUDA GPU.

Marked ``cuda``; each test skips when there is no card.  This file
imports no JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

Tolerances (atol, rtol): maxima are exact; f32 sums and projections in
another order, 1e-4; in bf16 the same order differences may move a
compute-dtype rounding to the other side, at the output or at an
intermediate point (bias adds, LayerNorm output, GELU; the attention
kernel's probabilities, rounded against a running max): one bf16 ulp is
at most 2^-7 relative and 2^-6 = 1.6e-2 absolute for outputs below 4.
"""
import numpy as np
import pytest
import torch

from geomae_tpu_torch.ops import attention_qkv, ffn, segment

INT_MAX = 2 ** 31 - 1
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
DTYPES = [torch.float32, torch.bfloat16]

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def segments(rng, B=2, P=4096, V=700):
    """Ascending ids with gaps, empty trailing rows, a sentinel suffix."""
    seg = np.sort(rng.integers(0, V - 20, (B, P)), axis=1).astype(np.int32)
    for b in range(B):
        seg[b, int(rng.integers(P // 2, P - 100)):] = V
    return torch.from_numpy(seg), V


def windows(rng, B=2, V=1024, win_size=150):
    win = np.full((B, V), INT_MAX, np.int32)
    for b in range(B):
        n, ids, w = int(rng.integers(V // 2, V - 100)), [], 0
        while len(ids) < n:
            ids.extend([w] * int(rng.integers(1, win_size + 1)))
            w += 3
        win[b, :n] = ids[:n]
    kv = (rng.random((B, V)) > 0.2) & (win != INT_MAX)
    return torch.from_numpy(win), torch.from_numpy(kv)


def check(got, want, atol, rtol):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,C", [("sum", 3), ("max", 128), ("max", 5)])
def test_segment_reduce(dev, dtype, op, C):
    rng = np.random.default_rng(0)
    seg, V = segments(rng)
    x = torch.randn(seg.shape + (C,), dtype=dtype)
    x, seg = x.to(dev), seg.to(dev)
    before = segment.segment_reduce.launches
    got = segment.segment_reduce(x, seg, V, op)
    assert segment.segment_reduce.launches == before + 1
    exact = op == "max"
    check(got, segment.segment_reduce_plain(x, seg, V, op),
          0 if exact else 1e-4, 0 if exact else 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op,C", [("mean", 3), ("max", 64), ("sum", 7)])
def test_segment_broadcast(dev, dtype, op, C):
    rng = np.random.default_rng(1)
    seg, V = segments(rng)
    x = (torch.randn(seg.shape + (C,)) * 10).to(dtype)
    x, seg = x.to(dev), seg.to(dev)
    got = segment.segment_broadcast(x, seg, V, op)
    want = segment.segment_broadcast_plain(x, seg, V, op)
    if op == "max":
        check(got, want, 0, 0)
    else:
        check(got, want, 1e-4, 1e-5 if dtype == torch.float32 else 2 ** -7)
    assert (got[seg == V] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_band_attention_qkv(dev, dtype):
    """Windows up to 150 tokens (more than a 12x12 window holds)."""
    rng = np.random.default_rng(2)
    win, kv = windows(rng)
    B, V = win.shape
    C = attention_qkv.KERNEL_C
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, V, C, generator=g).to(dtype)
    pos = torch.randn(B, V, C, generator=g)
    ws = [torch.randn(C, C, generator=g) * C ** -0.5 if i % 2 == 0
          else torch.randn(C, generator=g) * 0.1 for i in range(6)]
    args = [a.to(dev) for a in (x, pos, *ws, win, kv)] + [8]
    got = attention_qkv.band_attention_qkv(*args)
    check(got, attention_qkv.band_attention_qkv_plain(*args), *TOL[dtype])
    assert (got[win.to(dev) == INT_MAX] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_post_attention_block(dev, dtype):
    B, V, C, F = 2, 1000, ffn.KERNEL_C, ffn.KERNEL_F
    g = torch.Generator().manual_seed(1)
    r = lambda *s, scale=0.1: torch.randn(*s, generator=g) * scale
    x, attn = r(B, V, C, scale=1.0).to(dtype), r(B, V, C, scale=1.0).to(dtype)
    ws = [r(C, C), r(C), 1 + r(C), r(C), r(C, F), r(F), r(F, C), r(C),
          1 + r(C), r(C)]
    nv = torch.tensor([613, V], dtype=torch.int32)
    args = [a.to(dev) for a in (x, attn, *ws, nv)]
    got = ffn.post_attention_block(*args)
    check(got, ffn.post_attention_block_plain(*args), *TOL[dtype])
    assert (got[0, 613:] == 0).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(1, 64, 32, device=dev)
    win = torch.zeros(1, 64, dtype=torch.int32, device=dev)
    kv = torch.ones(1, 64, dtype=torch.bool, device=dev)
    w, b = torch.randn(32, 32, device=dev), torch.randn(32, device=dev)
    with pytest.raises(ValueError):       # C = 32: the kernel takes 128
        attention_qkv.band_attention_qkv(x, x, w, b, w, b, w, b, win, kv, 4)
    seg = torch.zeros(1, 64, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):       # int64 ids
        segment.segment_reduce(x, seg, 4, "sum")
    with pytest.raises(ValueError):       # non-contiguous
        segment.segment_reduce(x.transpose(1, 2), seg.int()[:, :32], 4, "sum")
