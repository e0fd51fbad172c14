"""K1 segment_reduce and K2 segment_broadcast: the port's plain versions
(what the CUDA kernels are held to) against the Pallas kernels in
interpret mode and against geomae_tpu.ops.scatter.

Tolerance 1e-6: f32 sums of at most a few dozen O(1) values in another
order; maxima are exact.  The scatter oracle runs its unsorted path (a
direct scatter-add): its sorted path differences a running cumsum, whose
f32 error grows with the prefix (5e-6 here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from geomae_tpu.ops import scatter as jscatter
from geomae_tpu.ops.pallas_segreduce import (segment_broadcast_pallas,
                                             segment_reduce_pallas)
from geomae_tpu_torch.ops import segment

B, P, V, CHUNK = 2, 512, 96, 128


def make_case(seed, C, ties):
    """Ascending ids with gaps (empty segments), empty trailing rows and a
    sentinel suffix; ``ties`` draws small integers so maxima tie."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, V - 8, (B, P)), axis=1).astype(np.int32)
    for b in range(B):
        seg[b, int(rng.integers(P // 2, P - 16)):] = V
    if ties:
        x = rng.integers(-3, 4, (B, P, C)).astype(np.float32)
    else:
        x = rng.normal(size=(B, P, C)).astype(np.float32)
    return x, seg


def occupied(seg):
    return np.stack([np.isin(np.arange(V), s) for s in seg])


def test_case_has_empty_segments_sentinels_and_ties():
    x, seg = make_case(0, 8, ties=True)
    occ = occupied(seg)
    assert (~occ[:, : V - 8]).any() and (~occ[:, V - 8:]).all()
    assert (seg == V).sum() > 16
    ties = 0
    for b in range(B):
        for s in np.flatnonzero(occ[b]):
            rows = x[b][seg[b] == s]
            ties += int(((rows == rows.max(0)).sum(0) > 1).sum())
    assert ties > 50


@pytest.mark.parametrize("op", ["sum", "max"])
@pytest.mark.parametrize("C", [3, 128])
def test_reduce_matches_pallas_and_scatter(op, C):
    x, seg = make_case(1, C, ties=op == "max")
    got = segment.segment_reduce(torch.from_numpy(x), torch.from_numpy(seg),
                                 V, op).numpy()
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(segment_reduce_pallas(
            jnp.asarray(x), jnp.asarray(seg), V, op == "max", CHUNK))
    occ = occupied(seg)
    np.testing.assert_allclose(got[occ], pal[occ], rtol=1e-6, atol=1e-6)
    for b in range(B):
        if op == "sum":
            want = jscatter.segment_sum(jnp.asarray(x[b]), jnp.asarray(seg[b]),
                                        V, sorted_ids=False)
        else:
            want = jscatter.segment_max(jnp.asarray(x[b]), jnp.asarray(seg[b]),
                                        V, empty_value=segment.NEG_FILL,
                                        sorted_ids=False)
        np.testing.assert_allclose(got[b], np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    empty = segment.NEG_FILL if op == "max" else 0.0
    assert (got[~occ] == empty).all()


@pytest.mark.parametrize("op", ["mean", "max"])
@pytest.mark.parametrize("C", [3, 64])
def test_broadcast_matches_pallas_and_scatter(op, C):
    x, seg = make_case(2, C, ties=op == "max")
    got = segment.segment_broadcast(torch.from_numpy(x),
                                    torch.from_numpy(seg), V, op).numpy()
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(segment_broadcast_pallas(
            jnp.asarray(x), jnp.asarray(seg), V, op, CHUNK))
    np.testing.assert_allclose(got, pal, rtol=1e-6, atol=1e-6)
    for b in range(B):
        xs, ss = jnp.asarray(x[b]), jnp.asarray(seg[b])
        if op == "mean":
            table = jscatter.segment_mean(xs, ss, V, sorted_ids=False)[0]
        else:
            table = jscatter.segment_max(xs, ss, V, sorted_ids=False)
        want = jscatter.take_rows_sorted(table, ss)
        np.testing.assert_allclose(got[b], np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert (got[seg == V] == 0).all()


def test_wrappers_dispatch_on_device():
    """CPU tensors take the plain version; a device with no kernel and an
    unknown op raise instead of falling back."""
    x, seg = make_case(3, 4, ties=False)
    xt, st = torch.from_numpy(x), torch.from_numpy(seg)
    assert torch.equal(segment.segment_reduce(xt, st, V, "max"),
                       segment.segment_reduce_plain(xt, st, V, "max"))
    with pytest.raises(ValueError):
        segment.segment_broadcast(xt.to("meta"), st.to("meta"), V, "max")
    with pytest.raises(ValueError):
        segment.segment_reduce(xt, st, V, "mean")
    assert segment.segment_reduce.launches == 0


def test_probe_segment_skewed_frame_and_histogram():
    """``probe_segment``'s skewed frame keeps the ids sorted dense ranks
    over the same points in segments, with one pillar holding the given
    share of them; its histogram counts every pillar once."""
    from geomae_tpu_torch import probe_segment

    _, seg = make_case(3, 4, False)
    p2v = torch.from_numpy(seg[:1])
    n = int((p2v < V).sum())
    skew = probe_segment.skewed(p2v, V, share=0.25)
    ids = skew[0, :n]
    assert (skew[0, n:] == V).all() and bool((ids[1:] >= ids[:-1]).all())
    assert set(ids.tolist()) == set(range(int(ids.max()) + 1))
    assert int(torch.bincount(ids.long()).max()) >= int(n * 0.25)
    hist, top = probe_segment.pillar_histogram(skew, V)
    assert sum(hist.values()) == int(ids.max()) + 1
    assert top == int(torch.bincount(ids.long()).max())
