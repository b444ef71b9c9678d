"""The port's training utilities (``cpu_vision_tpu_torch.train``: metrics, the
model EMA, checkpoints) against the JAX package's ``train/`` on the CPU, on
the same numpy values.  ``accuracy`` and ``SmoothedValue`` are exact (counts
and float64 statistics); the EMA after k updates agrees within 1e-6 (the
same float32 operations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu import train as jtrain
from cpu_vision_tpu.train import metrics as jmetrics
from cpu_vision_tpu_torch import models, train
from cpu_vision_tpu_torch.train import metrics


def test_accuracy_matches_jax(rng):
    logits = rng.standard_normal((40, 10)).astype(np.float32)
    logits[:5, :3] = 1.0  # ties, ranked by index on both sides
    targets = rng.integers(0, 10, 40)
    targets[:5] = 1
    ours = train.accuracy(torch.from_numpy(logits), torch.from_numpy(targets), topk=(1, 2, 5))
    ref = jtrain.accuracy(jnp.asarray(logits), jnp.asarray(targets), topk=(1, 2, 5))
    assert ours == ref and ours[0] <= ours[1] <= ours[2]


def test_smoothed_value_and_metric_logger_match_jax(rng, capsys):
    values = rng.standard_normal(30).tolist()
    ours, ref = train.SmoothedValue(window_size=7), jtrain.SmoothedValue(window_size=7)
    for i, v in enumerate(values):
        ours.update(v, n=1 + i % 3)
        ref.update(v, n=1 + i % 3)
    for stat in ("median", "avg", "global_avg", "max", "value"):
        assert getattr(ours, stat) == getattr(ref, stat), stat
    assert str(ours) == str(ref)
    logger, jlogger = train.MetricLogger(), jtrain.MetricLogger()
    for v in values[:5]:
        logger.update(loss=v, lr=0.1)
        jlogger.update(loss=v, lr=0.1)
    assert str(logger) == str(jlogger) and logger.loss.count == 5
    with pytest.raises(AttributeError):
        logger.acc1
    assert list(logger.log_every(range(3), 2, "step")) == [0, 1, 2]
    assert "step [2/3]" in capsys.readouterr().out


def test_ema_after_k_updates_matches_jax(rng):
    model = models.ConvNeXt((8,), (1,), num_classes=3)
    named = {k: v.clone() for k, v in model.state_dict().items()}

    def to_jax(state):  # copies: JAX may alias a numpy buffer and read it after the model's next in-place update
        return {k: jnp.array(v.numpy(), copy=True) for k, v in state.items()}

    ema, jema = train.ExponentialMovingAverage(model, decay=0.9), jtrain.ExponentialMovingAverage(to_jax(named), 0.9)
    for _ in range(4):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)))
        ema.update(model)
        jema.update(to_jax(model.state_dict()))
    state = ema.state_dict()
    assert state["decay"] == 0.9 and set(state["params"]) == set(named)
    for k, v in state["params"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jema.params[k]), rtol=1e-6, atol=1e-6)
    # a dict of tensors works as the model does; another set of names is refused
    by_dict = train.ExponentialMovingAverage(dict(named), decay=0.9)
    by_dict.update(model.state_dict())
    with pytest.raises(ValueError):
        by_dict.update({"x": torch.zeros(1)})


def test_checkpoint_round_trip(tmp_path, rng):
    model = models.ConvNeXt((8,), (1,), num_classes=3)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.from_numpy(rng.random((1, 16, 16, 3), dtype=np.float32)), train=True).sum().backward()
    opt.step()
    state = {"model": model.state_dict(), "optimizer": opt.state_dict(), "epoch": 3, "losses": [1.5, 1.25]}
    path = tmp_path / "ckpt.pt"
    train.save_checkpoint(str(path), state)
    back = train.load_checkpoint(str(path))
    assert back["epoch"] == 3 and back["losses"] == [1.5, 1.25]
    assert all(torch.equal(back["model"][k], v) for k, v in state["model"].items())
    other = torch.optim.SGD(models.ConvNeXt((8,), (1,), num_classes=3).parameters(), lr=0.1, momentum=0.9)
    other.load_state_dict(back["optimizer"])
    assert other.state_dict()["state"][0]["momentum_buffer"].shape == state["optimizer"]["state"][0][
        "momentum_buffer"].shape
    target = {"model": {k: v.to(torch.bfloat16) for k, v in state["model"].items()}}
    cast = train.load_checkpoint(str(path), target)
    assert all(v.dtype == torch.bfloat16 for v in cast["model"].values())
    params = train.load_params(str(path))
    assert set(params["model"]) == set(state["model"])
    with pytest.raises(ValueError, match="local files only"):
        train.load_params("https://example.invalid/weights.pt")
    with pytest.raises(FileNotFoundError):
        train.load_params(str(tmp_path / "missing.pt"))


def test_reduce_across_processes_without_a_group_is_the_identity():
    value = torch.tensor([1.0, 2.0])
    assert metrics.reduce_across_processes(value) is value
    assert jmetrics.reduce_across_processes(3.0) == 3.0


def test_reduce_across_processes_sums_over_a_process_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        out = metrics.reduce_across_processes([1.0, 2.5])
        assert torch.equal(out, torch.tensor([1.0, 2.5]))  # one process: its own values, as a tensor
    finally:
        dist.destroy_process_group()
