"""Training in the port (``models`` with ``train=True``,
``parallel.make_train_step``, ``ops.cnn_forward`` under autograd) against the
JAX package's models under ``jax.value_and_grad`` and ``optax.sgd``, on the
same numpy images, labels and parameters on the CPU.

A tiny ViT (2 layers, D 64, 2 heads, patch 8, 32x32 images) on each of its
routes, the JAX side on its fused kernels in interpret mode (their
``custom_vjp`` backward) or on ``FusedMHA``; a tiny ResNet (one block a stage,
basic and bottleneck) with batch statistics; the small CNN.  Weights cross
into the port through its carriers (``vit_state_dict_from_numpy``,
``resnet_state_dict_from_numpy``), gradients come back through the JAX
package's ``vit_from_torch`` / ``resnet_from_torch``.  Loss: cross entropy of float32
logits with integer labels (``bench_all.py:514``); 3 steps of SGD with
momentum 0.9, lr 0.01.  Float32 losses, gradients, parameters and running
statistics agree within ``1e-4·(1 + |ref|)`` (sums in other orders); the
ResNet's reference is the JAX model in float64 (see its test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from cpu_vision_tpu.models import resnet as jresnet
from cpu_vision_tpu.models import torch_weights
from cpu_vision_tpu.models import vision_transformer as jvit
from cpu_vision_tpu.ops import cnn as jcnn
from cpu_vision_tpu_torch import models, ops, parallel
from cpu_vision_tpu_torch.models.layers import dropout
from cpu_vision_tpu_torch.ops import kernels

TOL = 1e-4
# lr 0.01 is the JAX package's default.  At 0.1 three steps take a bottleneck ResNet's loss on 8 images from 3.1 to
# 0.2, and its float32 parameters end 3.4e-2·(1 + |ref|) from those of the float64 run: the problem's sensitivity
LR, MOMENTUM, STEPS = 0.01, 0.9, 3
VIT = dict(patch_size=8, num_layers=2, num_heads=2, hidden_dim=64, mlp_dim=128)


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


def _jax_run(loss_fn, params, aux, steps=STEPS):
    """``steps`` optax steps of ``loss_fn(params, aux) -> (loss, aux)``:
    (losses, first gradients, final params, final aux)."""
    tx = optax.sgd(LR, momentum=MOMENTUM)

    @jax.jit
    def step(params, opt, aux):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, aux)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, aux, loss, grads

    opt = tx.init(params)
    losses, first = [], None
    for _ in range(steps):
        params, opt, aux, loss, grads = step(params, opt, aux)
        losses.append(float(loss))
        first = grads if first is None else first
    return losses, first, params, aux


def _port_run(model, batch, steps=STEPS, **forward):
    """``steps`` steps of ``make_train_step``: (losses, first gradients by name)."""
    step = parallel.make_train_step(lambda m, b: (_xent(m(b[0], train=True, **forward), b[1]), {}),
                                    torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM))
    losses, first = [], None
    for _ in range(steps):
        loss, _ = step(model, batch)
        losses.append(float(loss))
        if first is None:
            first = {name: p.grad.clone() for name, p in model.named_parameters()}
    return losses, first


def _vit_state(rng, model):
    sd = model.state_dict()
    for key, value in sd.items():
        draw = rng.normal(0, 0.1, tuple(value.shape)).astype(np.float32)
        value.copy_(torch.from_numpy(draw + (1.0 if key.endswith(("ln_1.weight", "ln_2.weight", "ln.weight")) else 0.0)))
    return sd


@pytest.mark.parametrize("attention,mlp", [(None, None), ("block", "block"), ("flash", "plain")])
def test_vit_train_steps_match_jax(rng, monkeypatch, attention, mlp):
    images = rng.random((4, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, 4)
    # the JAX side: its fused attention block, or FusedMHA around flash_mha; at D 64 its rule takes the plain MLP
    monkeypatch.setattr(jvit, "FUSED_ATTENTION", attention != "flash")
    model = models.VisionTransformer(**VIT, num_classes=10, image_size=32, attention=attention, mlp=mlp)
    sd = {k: v.clone() for k, v in _vit_state(rng, model).items()}
    jmodel = jvit.VisionTransformer(**VIT, num_classes=10)

    def loss_fn(p, aux):
        logits = jmodel.apply({"params": p}, jnp.asarray(images), train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), jnp.asarray(labels)).mean(), aux

    params = torch_weights.vit_from_torch(sd, 2, 2)["params"]
    model.load_state_dict(models.vit_state_dict_from_numpy(_numpy_tree(params), 2, 2))  # in through the carrier
    ref_losses, ref_grads, ref_params, _ = _jax_run(loss_fn, params, None)
    losses, grads = _port_run(model, (torch.from_numpy(images), torch.from_numpy(labels)))
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL, atol=TOL)
    _assert_trees_close(_numpy_tree(torch_weights.vit_from_torch(grads, 2, 2)["params"]), _numpy_tree(ref_grads))
    _assert_trees_close(_numpy_tree(torch_weights.vit_from_torch(model.state_dict(), 2, 2)["params"]),
                        _numpy_tree(ref_params))
    assert all(v == 0 for v in kernels.launch_counts().values())  # CPU tensors launch nothing


def _resnet_state(rng, model):
    sd = model.state_dict()
    for key, value in sd.items():
        if key.endswith("running_var"):
            value.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, tuple(value.shape)).astype(np.float32)))
        elif key.endswith("num_batches_tracked"):
            continue
        elif "bn" in key or "downsample.1" in key:
            offset = 1.0 if key.endswith("weight") else 0.0
            value.copy_(torch.from_numpy((offset + rng.normal(0, 0.3, tuple(value.shape))).astype(np.float32)))
        elif key.endswith("bias"):
            value.copy_(torch.from_numpy(rng.normal(0, 0.1, tuple(value.shape)).astype(np.float32)))
    return sd


@pytest.mark.parametrize("bottleneck", [False, True], ids=["basic", "bottleneck"])
def test_resnet_train_steps_and_batch_stats_match_jax(rng, bottleneck):
    layers = (1, 1, 1, 1)
    block, jblock = (models.Bottleneck, jresnet.Bottleneck) if bottleneck else (models.BasicBlock, jresnet.BasicBlock)
    images = rng.random((8, 32, 32, 3), dtype=np.float32)  # layer 4 sees 8 values a channel: (n - 1) / n = 7/8
    labels = rng.integers(0, 10, 8)
    model = models.ResNet(block, layers, num_classes=10, generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in _resnet_state(rng, model).items()}
    variables = torch_weights.resnet_from_torch(sd, layers, bottleneck)
    model.load_state_dict(models.resnet_state_dict_from_numpy(_numpy_tree(variables), layers, bottleneck))
    # the reference is the JAX model run in float64 on the same float32 values: its own float32 run strays from that
    # by up to 3.8e-3 in the gradients of a batch of 8 at 64x64 (XLA's float32 reductions), where the port's
    # stays within 2e-6
    with jax.enable_x64(True):
        jmodel = jresnet.ResNet(block=jblock, layers=layers, num_classes=10, dtype=jnp.float64)
        x64 = jnp.asarray(images, jnp.float64)

        def loss_fn(p, stats):
            logits, mut = jmodel.apply({"params": p, "batch_stats": stats}, x64, train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()
            return loss, mut["batch_stats"]

        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        ref_losses, ref_grads, ref_params, ref_stats = _jax_run(loss_fn, v64["params"], v64["batch_stats"])
        ref_grads, ref_params, ref_stats = (_numpy_tree(t) for t in (ref_grads, ref_params, ref_stats))
        ref_logits = np.asarray(jax.jit(lambda v: jmodel.apply(v, x64, train=False))(
            {"params": ref_params, "batch_stats": ref_stats}))
    losses, grads = _port_run(model, (torch.from_numpy(images), torch.from_numpy(labels)))
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL, atol=TOL)
    grad_sd = {**model.state_dict(), **grads}
    _assert_trees_close(_numpy_tree(torch_weights.resnet_from_torch(grad_sd, layers, bottleneck)["params"]), ref_grads)
    after = _numpy_tree(torch_weights.resnet_from_torch(model.state_dict(), layers, bottleneck))
    _assert_trees_close(after["params"], ref_params)
    _assert_trees_close(after["batch_stats"], ref_stats)
    assert int(model.bn1.num_batches_tracked) == STEPS
    # serving afterwards normalises by the moved running statistics, with no graph
    out = model(torch.from_numpy(images))
    assert out.grad_fn is None
    np.testing.assert_allclose(out.numpy(), ref_logits, atol=TOL, rtol=TOL)


def test_resnet_bfloat16_gradients_stand_no_further_from_float32_than_jaxs(rng):
    """At random weights a ResNet's batch norms cancel most of each gradient, so bfloat16 gradients stand far from
    float32 ones in either package (about a fifth of the norm here).  The port's distance is held to at most 1.25
    times the JAX package's on the same weights and images (bench_all.py's bf16 training recipe)."""
    layers = (1, 1, 1, 1)
    images = rng.random((8, 32, 32, 3), dtype=np.float32)
    labels = rng.integers(0, 10, 8)
    model = models.ResNet(models.Bottleneck, layers, num_classes=10, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():  # else each block's last batch-norm scale is 0 and its branch gets no gradient
        for stage in (model.layer1, model.layer2, model.layer3, model.layer4):
            stage[0].last_bn.weight.fill_(0.25)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    variables = torch_weights.resnet_from_torch(sd, layers, True)

    def port(dtype):
        m = models.ResNet(models.Bottleneck, layers, num_classes=10, dtype=dtype)
        m.load_state_dict(sd)
        _xent(m(torch.from_numpy(images), train=True), torch.from_numpy(labels)).backward()
        grads = {**sd, **{n: p.grad for n, p in m.named_parameters()}}
        return _numpy_tree(torch_weights.resnet_from_torch(grads, layers, True)["params"])

    def jax_grads(dtype):
        jmodel = jresnet.ResNet(block=jresnet.Bottleneck, layers=layers, num_classes=10, dtype=dtype)

        def loss_fn(p):
            logits, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(images),
                                     train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), jnp.asarray(labels)).mean()

        return _numpy_tree(jax.jit(jax.grad(loss_fn))(variables["params"]))

    def distance(a, b):
        a, b = (np.concatenate([np.ravel(x).astype(np.float64) for x in jax.tree_util.tree_leaves(t)]) for t in (a, b))
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    port32 = port(torch.float32)
    jax32 = jax_grads(jnp.float32)
    assert distance(port32, jax32) <= TOL
    port_gap, jax_gap = distance(port(torch.bfloat16), port32), distance(jax_grads(jnp.bfloat16), jax32)
    assert 0.05 < jax_gap and port_gap <= 1.25 * jax_gap, (port_gap, jax_gap)


@pytest.mark.parametrize("backend", ["kernel", "plain", "stock"])
def test_cnn_grads_match_jax(rng, backend):
    cfg = dict(input_hw=(28, 28), in_channels=1, conv_channels=(8, 16), hidden=32, num_classes=10)
    jparams = jcnn.cnn_init(jax.random.PRNGKey(0), **cfg)
    images = rng.random((4, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, 4)

    def loss_fn(p):
        logits = jcnn.cnn_forward(p, jnp.asarray(images))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    params = ops.cnn_params_from_numpy(_numpy_tree(jparams), device="cpu")
    leaves = [t.requires_grad_() for layer in params.values() for t in layer.values()]
    loss = _xent(ops.cnn_forward(params, torch.from_numpy(images), backend=backend), torch.from_numpy(labels))
    loss.backward()
    assert all(t.grad is not None for t in leaves)  # the conv stage passes gradients on every route
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=TOL)
    _assert_trees_close({k: {n: t.grad.numpy() for n, t in v.items()} for k, v in params.items()},
                        _numpy_tree(ref_grads))


def test_default_optimizer_is_sgd_with_lr_001():
    model = torch.nn.Linear(3, 2)
    x = torch.arange(6.0).reshape(2, 3)
    before = [p.detach().clone() for p in model.parameters()]
    step = parallel.make_train_step(lambda m, b: (m(b).square().sum(), {"n": len(b)}))
    loss, aux = step(model, x)
    assert aux == {"n": 2} and loss.grad_fn is None
    for p, b in zip(model.parameters(), before):
        torch.testing.assert_close(p.detach(), b - 0.01 * p.grad, rtol=0, atol=1e-7)


def test_train_step_refuses_an_optimizer_of_another_model():
    model, other = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    before = [p.detach().clone() for p in model.parameters()]
    step = parallel.make_train_step(lambda m, b: (m(b).square().sum(), {}), torch.optim.SGD(other.parameters(), lr=0.1))
    with pytest.raises(ValueError, match="does not hold"):
        step(model, torch.ones(2, 3))
    assert all(torch.equal(p, b) for p, b in zip(model.parameters(), before))


def test_batch_norm_recording_shows_inputs_and_running_stats(rng):
    """``resnet.recording()`` yields each training batch norm's input and its running statistics before the step;
    from them flax's rule (biased variance, 0.9 / 0.1) gives the running statistics after it, within 1e-6 (float32
    sums in another order).  Serving, and training outside the block, record nothing."""
    model = models.ResNet(models.BasicBlock, (1, 1, 1, 1), num_classes=10, generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(rng.random((4, 32, 32, 3), dtype=np.float32))
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with models.resnet.recording() as calls:
        model(images)
        assert calls == []
        with torch.no_grad():
            for bn in bns:
                bn.running_mean.uniform_(-1, 1)
                bn.running_var.uniform_(0.5, 2)
        before = {bn: (bn.running_mean.clone(), bn.running_var.clone()) for bn in bns}
        model(images, train=True)
    assert sorted(map(id, (c[0] for c in calls))) == sorted(map(id, bns)) and len(calls) == len(bns) == 12
    for bn, x, mean0, var0 in calls:
        assert torch.equal(mean0, before[bn][0]) and torch.equal(var0, before[bn][1])
        x64 = x.double()
        want_mean = 0.9 * mean0.double() + 0.1 * x64.mean(dim=(0, 2, 3))
        want_var = 0.9 * var0.double() + 0.1 * x64.var(dim=(0, 2, 3), unbiased=False)
        assert float(((bn.running_mean.double() - want_mean).abs() / (1 + want_mean.abs())).max()) <= 1e-6
        assert float(((bn.running_var.double() - want_var).abs() / want_var).max()) <= 1e-6
    model(images, train=True)
    assert len(calls) == 12


def test_sgd_momentum_is_optax_momentum(rng):
    w0 = rng.standard_normal(5).astype(np.float32)
    targets = rng.standard_normal((STEPS, 5)).astype(np.float32)
    tx = optax.sgd(LR, momentum=MOMENTUM)
    params = jnp.asarray(w0)
    opt = tx.init(params)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    sgd = torch.optim.SGD([w], lr=LR, momentum=MOMENTUM)
    for t in targets:
        grads = jax.grad(lambda p: jnp.sum((p - t) ** 3))(params)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        sgd.zero_grad()
        ((w - torch.from_numpy(t)) ** 3).sum().backward()
        sgd.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), rtol=1e-6, atol=1e-6)


def test_vit_dropout_routes_and_masks(rng):
    images = torch.from_numpy(rng.random((2, 32, 32, 3), dtype=np.float32))
    model = models.VisionTransformer(**VIT, num_classes=10, image_size=32, dropout=0.1,
                                     generator=torch.Generator().manual_seed(0))
    assert model.routes() == ("plain", "plain")  # serving: the JAX rule by shape (head dim 32)
    assert model.routes(train=True) == ("plain", "plain")
    wide = models.VisionTransformer(patch_size=8, num_layers=1, num_heads=2, hidden_dim=128, mlp_dim=256,
                                    image_size=32, dropout=0.1)
    assert wide.routes() == ("block", "block") and wide.routes(train=True) == ("flash", "plain")
    wide.encoder.layers[0].attention_dropout = 0.1
    assert wide.routes(train=True) == ("plain", "plain")
    with pytest.raises(ValueError):
        models.VisionTransformer(**VIT, image_size=32, dropout=0.1, attention="block").routes(train=True)
    with pytest.raises(ValueError):
        models.VisionTransformer(**VIT, image_size=32, dropout=0.1, mlp="block").routes(train=True)
    # the masks come from the generator: one seed, one result; the serving forward is unchanged by it
    first = model(images, train=True, generator=torch.Generator().manual_seed(3))
    again = model(images, train=True, generator=torch.Generator().manual_seed(3))
    other = model(images, train=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(first, again) and not torch.equal(first, other) and first.grad_fn is not None
    assert torch.equal(model(images), model(images)) and model(images).grad_fn is None
    x = torch.ones(100_000)
    y = dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, float(torch.tensor(1.0 / 0.75))} and abs(float((y == 0).float().mean()) - 0.25) < 0.01
    assert dropout(x, 0.0) is x
    with pytest.raises(ValueError):
        dropout(x, 1.0)
