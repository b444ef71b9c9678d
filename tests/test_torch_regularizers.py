"""The port's stochastic regularisers (``ops.stochastic_depth``,
``drop_block2d``, ``drop_block3d``) against the JAX package's
``ops/regularizers.py`` on the CPU.

The two packages draw different random numbers from one seed, so where a
draw decides the output both sides are handed the same numpy keep bits or
seeds (``jax.random.bernoulli`` and the port's ``_bernoulli`` replaced for the
call); at p 0, p 1 and ``training=False`` nothing random decides.  The
arithmetic is the same float32 operations on both sides: equal within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops import regularizers as jreg
from cpu_vision_tpu_torch import ops
from cpu_vision_tpu_torch.ops import regularizers

SHAPES = {"stochastic_depth": (4, 5, 6, 3), "drop_block2d": (2, 9, 8, 3), "drop_block3d": (2, 5, 6, 7, 2)}


def _port_call(name, x, p, training=True, generator=None, block_size=3):
    if name == "stochastic_depth":
        return ops.stochastic_depth(x, p, "row", training, generator)
    return getattr(ops, name)(x, p, block_size, training=training, generator=generator)


def _jax_call(name, x, p, training=True, block_size=3):
    key = jax.random.PRNGKey(0)
    if name == "stochastic_depth":
        return jreg.stochastic_depth(x, p, "row", training, key)
    return getattr(jreg, name)(x, p, block_size, training=training, key=key)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("p,training", [(0.0, True), (0.3, False), (1.0, True)], ids=["p0", "serving", "p1"])
def test_deterministic_cases_equal_jax(rng, name, p, training):
    shape = SHAPES[name]
    block = 3
    if p == 1.0 and name != "stochastic_depth":
        # at p 1 DropBlock is certain only where its block covers a square map (gamma = p); stochastic depth drops
        # every row
        shape = (2,) + (6,) * (len(shape) - 2) + (3,)
        block = 6
    x = rng.standard_normal(shape).astype(np.float32)
    out = _port_call(name, torch.from_numpy(x), p, training, torch.Generator().manual_seed(0), block)
    ref = np.asarray(_jax_call(name, jnp.asarray(x), p, training, block))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)
    if p == 1.0:
        assert bool((out == 0).all())
    else:
        assert torch.equal(out, torch.from_numpy(x))


@pytest.mark.parametrize("name", list(SHAPES))
def test_the_same_value_errors_as_jax(name):
    x = np.zeros(SHAPES[name], np.float32)
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError, match="p must be in"):
            _jax_call(name, jnp.asarray(x), bad)
        with pytest.raises(ValueError, match="p must be in"):
            _port_call(name, torch.from_numpy(x), bad)
    if name == "stochastic_depth":
        with pytest.raises(ValueError, match="mode must be"):
            jreg.stochastic_depth(jnp.asarray(x), 0.5, "column", True, jax.random.PRNGKey(0))
        with pytest.raises(ValueError, match="mode must be"):
            ops.stochastic_depth(torch.from_numpy(x), 0.5, "column", True)
    else:
        wrong = np.zeros((2, 4, 4), np.float32)
        with pytest.raises(ValueError, match="expected"):
            _jax_call(name, jnp.asarray(wrong), 0.5)
        with pytest.raises(ValueError, match="expected"):
            _port_call(name, torch.from_numpy(wrong), 0.5)


def _given_bits(monkeypatch, bits):
    """Both packages draw ``bits`` (numpy bool) in place of their random numbers."""
    def jax_bernoulli(key, p, shape):
        assert tuple(shape) == bits.shape
        return jnp.asarray(bits)

    def port_bernoulli(shape, rate, dtype, device, generator):
        assert tuple(shape) == bits.shape
        return torch.from_numpy(bits).to(dtype)

    monkeypatch.setattr(jreg.jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(regularizers, "_bernoulli", port_bernoulli)


@pytest.mark.parametrize("mode", ["row", "batch"])
def test_stochastic_depth_on_the_same_bits_equals_jax(rng, monkeypatch, mode):
    x = rng.standard_normal((6, 4, 5, 3)).astype(np.float32)
    shape = (6, 1, 1, 1) if mode == "row" else (1, 1, 1, 1)
    bits = np.array([True, False, True, True, False, True]).reshape(shape) if mode == "row" else np.ones(shape, bool)
    _given_bits(monkeypatch, bits)
    out = ops.stochastic_depth(torch.from_numpy(x), 0.2, mode, True)
    ref = np.asarray(jreg.stochastic_depth(jnp.asarray(x), 0.2, mode, True, jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(out.numpy(), ref)
    # the kept rows are scaled by exactly 1 / (1 - p), the others zero
    assert torch.equal(out, torch.from_numpy(x) * torch.from_numpy(bits.astype(np.float32) / np.float32(0.8)))


@pytest.mark.parametrize("name,block_size", [("drop_block2d", 3), ("drop_block2d", 4), ("drop_block3d", 3),
                                             ("drop_block3d", 2)])
def test_drop_block_on_the_same_seeds_equals_jax(rng, monkeypatch, name, block_size):
    x = rng.standard_normal(SHAPES[name]).astype(np.float32)
    spatial = SHAPES[name][1:-1]
    valid = tuple(s - block_size + 1 for s in spatial)
    seeds = rng.random((x.shape[0], *valid, x.shape[-1])) < 0.1
    _given_bits(monkeypatch, seeds)
    out = _port_call(name, torch.from_numpy(x), 0.4, block_size=block_size).numpy()
    ref = np.asarray(_jax_call(name, jnp.asarray(x), 0.4, block_size=block_size))
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    # the zeros are block_size-wide squares (cubes) starting at each seed, the rest scaled by numel / (eps + Σ mask)
    dropped = np.zeros(x.shape, bool)
    for idx in zip(*np.nonzero(seeds)):
        n, pos, c = idx[0], idx[1:-1], idx[-1]
        dropped[(n, *(slice(q, q + block_size) for q in pos), c)] = True
    mask = (~dropped).astype(np.float32)
    np.testing.assert_allclose(out, x * mask * (mask.size / (1e-6 + mask.sum())), rtol=1e-6, atol=1e-6)
    assert dropped.any() and not dropped.all()


def test_draws_have_the_row_and_batch_shapes_and_follow_the_seed(rng):
    x = torch.ones(64, 3, 2)
    rows = ops.stochastic_depth(x, 0.5, "row", True, torch.Generator().manual_seed(1))
    assert all(bool((r == r[0, 0]).all()) for r in rows)  # one bit a row
    assert {float(v) for v in rows[:, 0, 0]} == {0.0, 2.0}
    batch = ops.stochastic_depth(x, 0.5, "batch", True, torch.Generator().manual_seed(1))
    assert len(set(batch.flatten().tolist())) == 1
    again = ops.stochastic_depth(x, 0.5, "row", True, torch.Generator().manual_seed(1))
    assert torch.equal(rows, again)
    assert not torch.equal(rows, ops.stochastic_depth(x, 0.5, "row", True, torch.Generator().manual_seed(2)))
    y = torch.from_numpy(rng.standard_normal((2, 12, 12, 3)).astype(np.float32))
    first = ops.drop_block2d(y, 0.3, 3, generator=torch.Generator().manual_seed(5))
    assert torch.equal(first, ops.drop_block2d(y, 0.3, 3, generator=torch.Generator().manual_seed(5)))
    assert bool((first == 0).any())
