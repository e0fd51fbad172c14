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
from geomae_tpu_torch.ops.ffn import (post_attention_block,
                                      post_attention_block_plain)
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
