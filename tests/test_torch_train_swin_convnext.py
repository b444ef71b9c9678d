"""Swin and ConvNeXt training in the port (``forward(x, train=True,
generator=g)`` under ``parallel.make_train_step``) against the JAX package's
models under ``jax.value_and_grad`` and ``optax.sgd`` with momentum, on the
same numpy images, labels and parameters on the CPU.

At stochastic depth 0 every block takes its fused kernels on both sides (the
port's twins here, the JAX package's Pallas kernels in interpret mode under
their ``custom_vjp``): tiny Swin v1 and v2 (embed dim 16, depths (2, 2),
heads (2, 4), window 4, 32x32 images) on explicit kernel routes, and a tiny
ConvNeXt.  With two blocks at ``sd_prob`` 1.0, block 0 (probability 0) is
fused and block 1 (probability 1) takes the plain route and is always
dropped, so both sides are deterministic and the mixed routes are held
against JAX on the ``None`` routes (Swin at C 96, head dim 32, the kernels'
widths).  Weights cross through the carriers, gradients come back through
the JAX package's ``swin_from_torch`` / ``convnext_from_torch``.  Float32
losses and gradients agree within ``1e-4·(1 + |ref|)``, as in
``test_torch_train.py`` (sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from cpu_vision_tpu.models import convnext as jconvnext
from cpu_vision_tpu.models import swin as jswin
from cpu_vision_tpu.models import torch_weights
from cpu_vision_tpu_torch import models, parallel
from cpu_vision_tpu_torch.ops import kernels

TOL = 1e-4
LR, MOMENTUM, STEPS = 0.01, 0.9, 3
SWIN = dict(embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4)
SWIN_WIDE = dict(embed_dim=96, depths=(2,), num_heads=(3,), window_size=4)  # head dim 32, C 96: the kernels' widths
CLASSES = 9


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(tree, ref, tol=TOL):
    leaves, ref_leaves = jax.tree_util.tree_leaves_with_path(tree), jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in leaves] == [p for p, _ in ref_leaves]
    for (path, a), (_, b) in zip(leaves, ref_leaves):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape and np.all(np.abs(a - b) <= tol * (1 + np.abs(b))), (path, np.abs(a - b).max())


def _xent(logits, labels):
    return F.cross_entropy(logits.float(), labels)


def _jax_run(jmodel, params, images, labels):
    """``STEPS`` optax steps of cross entropy: (losses, first gradients)."""
    tx = optax.sgd(LR, momentum=MOMENTUM)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(images), train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), jnp.asarray(labels)).mean()

    @jax.jit
    def step(p, opt):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt = tx.update(grads, opt, p)
        return optax.apply_updates(p, updates), opt, loss, grads

    opt, losses, first = tx.init(params), [], None
    for _ in range(STEPS):
        params, opt, loss, grads = step(params, opt)
        losses.append(float(loss))
        first = grads if first is None else first
    return losses, first


def _port_run(model, images, labels, generator=None, steps=STEPS):
    """``steps`` steps of ``make_train_step``: (losses, first gradients by name)."""
    step = parallel.make_train_step(lambda m, b: (_xent(m(b[0], train=True, generator=generator), b[1]), {}),
                                    torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM))
    losses, first = [], None
    for _ in range(steps):
        loss, _ = step(model, (torch.from_numpy(images), torch.from_numpy(labels)))
        losses.append(float(loss))
        if first is None:
            first = {name: p.grad.clone() for name, p in model.named_parameters()}
    return losses, first


def _swin_state(rng, model):
    """Every entry random; LayerNorm weights around 1, logit scales around ln 10."""
    sd = model.state_dict()
    for key, value in sd.items():
        draw = rng.normal(0, 0.1, tuple(value.shape)).astype(np.float32)
        shift = 1.0 if key.endswith(("norm1.weight", "norm2.weight", "norm.weight", "features.0.2.weight")) else \
            2.3 if key.endswith("logit_scale") else 0.0
        value.copy_(torch.from_numpy(draw + shift))
    return {k: v.clone() for k, v in sd.items()}


def _convnext_state(rng, model):
    """Every entry random; LayerNorm weights around 1, the layer scale around 0.5 (at its 1e-6 the blocks'
    branches would not show)."""
    sd = model.state_dict()
    for key, value in sd.items():
        draw = rng.normal(0, 0.1, tuple(value.shape)).astype(np.float32)
        norm = key.endswith(("block.2.weight", "features.0.1.weight", "0.weight")) and value.ndim == 1
        value.copy_(torch.from_numpy(draw + (1.0 if norm else 0.5 if key.endswith("layer_scale") else 0.0)))
    return {k: v.clone() for k, v in sd.items()}


def _data(rng, n=2):
    return rng.random((n, 32, 32, 3), dtype=np.float32), rng.integers(0, CLASSES, n)


def _swin_case(rng, cfg, v2, sd_prob, **routes):
    images, labels = _data(rng)
    model = models.SwinTransformer(**cfg, sd_prob=sd_prob, num_classes=CLASSES, v2=v2, **routes)
    sd = _swin_state(rng, model)
    depths = cfg["depths"]
    params = torch_weights.swin_from_torch(sd, depths)["params"]
    model.load_state_dict(models.swin_state_dict_from_numpy(_numpy_tree(params), depths))  # in through the carrier
    jmodel = jswin.SwinTransformer(**cfg, sd_prob=sd_prob, num_classes=CLASSES, v2=v2)
    ref_losses, ref_grads = _jax_run(jmodel, params, images, labels)
    losses, grads = _port_run(model, images, labels, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL, atol=TOL)
    _assert_trees_close(_numpy_tree(torch_weights.swin_from_torch(grads, depths)["params"]), _numpy_tree(ref_grads))
    assert all(v == 0 for v in kernels.launch_counts().values())  # CPU tensors launch nothing
    return model


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_swin_train_steps_at_sd0_match_jax(rng, monkeypatch, v2):
    monkeypatch.setattr(jswin, "FUSED_ATTENTION", True)
    monkeypatch.setattr(jswin, "FUSED_MLP", True)
    model = _swin_case(rng, SWIN, v2, 0.0, attention="block", mlp="block")
    assert model.routes(2, 32, 32, train=True) == [("block", "block")] * 4


def test_swin_two_blocks_at_sd1_mix_the_routes_as_jax(rng, monkeypatch):
    monkeypatch.setattr(jswin, "FUSED_ATTENTION", True)
    monkeypatch.setattr(jswin, "FUSED_MLP", True)
    model = _swin_case(rng, SWIN_WIDE, False, 1.0)
    # block 0 at probability 0 keeps the kernels under training, block 1 at probability 1 takes the plain routes
    assert model.routes(2, 32, 32, train=True) == [("block", "block"), ("plain", "plain")]
    assert model.routes(2, 32, 32) == [("block", "block")] * 2


def _convnext_case(rng, dims, depths, sd_prob):
    images, labels = _data(rng)
    model = models.ConvNeXt(dims, depths, sd_prob=sd_prob, num_classes=CLASSES)
    sd = _convnext_state(rng, model)
    params = torch_weights.convnext_from_torch(sd)["params"]
    model.load_state_dict(models.convnext_state_dict_from_numpy(_numpy_tree(params)))
    jmodel = jconvnext.ConvNeXt(dims, depths, sd_prob=sd_prob, num_classes=CLASSES)
    ref_losses, ref_grads = _jax_run(jmodel, params, images, labels)
    losses, grads = _port_run(model, images, labels, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL, atol=TOL)
    grad_sd = {**sd, **grads}
    _assert_trees_close(_numpy_tree(torch_weights.convnext_from_torch(grad_sd)["params"]), _numpy_tree(ref_grads))
    return model


def test_convnext_train_steps_at_sd0_match_jax(rng):
    model = _convnext_case(rng, (8, 16), (1, 2), 0.0)
    assert model.routes(train=True) == [("block", "stock")] * 3


def test_convnext_two_blocks_at_sd1_mix_the_routes_as_jax(rng):
    model = _convnext_case(rng, (8,), (2,), 1.0)
    assert model.routes(train=True) == [("block", "stock"), ("plain", "stock")]
    assert model.routes() == [("block", "stock")] * 2


@pytest.mark.parametrize("name,sd_prob", [("swin_t", None), ("swin_v2_t", 0.0), ("convnext_tiny", None),
                                          ("convnext_tiny", 0.0)])
def test_training_routes_copy_the_jax_rule(name, sd_prob):
    """JAX fuses a block under training only where its stochastic depth is 0 (``models/swin.py:265``, ``:322``,
    ``models/convnext.py:32``), else as when serving; the registered models take ``sd_prob`` by keyword."""
    kw = {} if sd_prob is None else {"sd_prob": sd_prob}
    model = models.get_model(name, device="cpu", dtype=torch.bfloat16, **kw)
    blocks = model.blocks()
    probs = [b.stochastic_depth.p for b in blocks]
    total = len(blocks)
    last = model.blocks()[-1].stochastic_depth.p
    assert probs == [pytest.approx(last * i / (total - 1)) for i in range(total)]
    if "swin" in name:
        size = 256 if "v2" in name else 224
        serving, training = model.routes(128, size, size), model.routes(128, size, size, train=True)
    else:
        serving, training = model.routes(), model.routes(train=True)
    plain = ("plain", "plain") if "swin" in name else ("plain", "stock")
    assert training == [s if p == 0.0 else plain for s, p in zip(serving, probs)]
    assert (probs[1] > 0) == (sd_prob is None)


def test_a_seeded_step_is_the_same_twice_and_on_either_route(rng):
    """Two models from one state, stepped with generators of one seed, drop the same rows: the same losses and
    gradients, bit for bit; and the kernel routes (``None``, block 0 fused) draw as the plain routes do."""
    images, labels = _data(rng, 4)
    base = models.SwinTransformer(**SWIN_WIDE, sd_prob=0.5, num_classes=CLASSES)
    sd = _swin_state(rng, base)
    runs = []
    for routes in ({}, {}, {"attention": "plain", "mlp": "plain"}):
        model = models.SwinTransformer(**SWIN_WIDE, sd_prob=0.5, num_classes=CLASSES, **routes)
        model.load_state_dict(sd)
        runs.append(_port_run(model, images, labels, torch.Generator().manual_seed(7), steps=2))
    (losses, grads), (losses_again, grads_again), (plain_losses, plain_grads) = runs
    assert losses == losses_again and all(torch.equal(grads[k], grads_again[k]) for k in grads)
    np.testing.assert_allclose(losses, plain_losses, rtol=TOL, atol=TOL)
    for k in grads:
        assert torch.allclose(grads[k], plain_grads[k], rtol=TOL, atol=TOL), k
    # a draw that drops something: the same step with another seed gives another loss
    other = models.SwinTransformer(**SWIN_WIDE, sd_prob=0.5, num_classes=CLASSES)
    other.load_state_dict(sd)
    assert _port_run(other, images, labels, torch.Generator().manual_seed(8), steps=1)[0][0] != losses[0]
