"""geomae_tpu_torch.weights.from_flax against the JAX package's torch
checkpoint import: the port's state_dict is the reference's, so the two
mappings are inverses, bitwise, and the port loads it strictly."""
import jax
import numpy as np
import pytest
import torch

from geomae_tpu.config import tiny_finetune_config
from geomae_tpu.train import finetune as FT
from geomae_tpu.train.torch_import import import_torch_weights
from geomae_tpu_torch.models.detector import DynamicVoxelNet
from geomae_tpu_torch.weights import from_flax


def randomized_state(cfg, seed=0):
    """Fine-tune params and batch_stats of the JAX detector, every leaf
    perturbed from its init so that no two leaves agree by accident:
    kernels keep their init, biases / scales move by N(0, 0.1), BN means
    by N(0, 0.1) and variances to 1 + |N(0, 0.2)|."""
    state, _ = FT.init_state(cfg, 1, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = path[-1].key
        if name == "kernel":
            return a
        if name == "var":
            return (1 + np.abs(rng.normal(0, 0.2, a.shape))).astype(np.float32)
        return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, state.params)
    stats = jax.tree_util.tree_map_with_path(perturb, state.batch_stats)
    return params, stats


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_finetune_config()
    params, stats = randomized_state(cfg)
    return cfg, params, stats


def test_from_flax_loads_strictly(tiny):
    cfg, params, stats = tiny
    sd = from_flax(params, stats)
    model = DynamicVoxelNet(cfg)
    model.load_state_dict(sd, strict=True)
    got = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def test_round_trip_through_torch_import_is_bitwise(tiny):
    """flax -> from_flax -> import_torch_weights -> flax, every leaf."""
    cfg, params, stats = tiny
    sd = {k: v.numpy() for k, v in from_flax(params, stats).items()}
    zeros = lambda t: jax.tree.map(np.zeros_like, t)
    p2, s2, report = import_torch_weights(zeros(params), zeros(stats), sd,
                                          "finetune")
    assert report["missing"] == []
    assert report["unconsumed"] == []
    for a, b in ((params, p2), (stats, s2)):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_reference_state_dict_round_trip(tiny):
    """A state_dict in the reference's names (here: the port's own, with
    random values) -> flax -> back: unchanged, bitwise."""
    cfg, params, stats = tiny
    model = DynamicVoxelNet(cfg)
    g = torch.Generator().manual_seed(1)
    sd = {k: (torch.rand(v.shape, generator=g) + 0.5
              if v.is_floating_point() else v)
          for k, v in model.state_dict().items()}
    zeros = lambda t: jax.tree.map(np.zeros_like, t)
    p2, s2, report = import_torch_weights(
        zeros(params), zeros(stats), {k: v.numpy() for k, v in sd.items()},
        "finetune")
    assert report["missing"] == [] and report["unconsumed"] == []
    back = from_flax(jax.tree.map(np.asarray, p2),
                     jax.tree.map(np.asarray, s2))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
