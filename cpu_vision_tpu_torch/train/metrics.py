"""Metric logging (PyTorch).

Counterpart of the JAX package's ``train/metrics.py`` (the reference's
``references/classification/utils.py:14-115``): ``SmoothedValue`` keeps
windowed statistics of a series, ``MetricLogger.log_every`` wraps an
iterable and prints throughput and ETA, ``accuracy`` gives top-k accuracies
of a batch of logits.  ``reduce_across_processes`` sums over the processes of
``torch.distributed`` where the JAX package gathers over JAX processes.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable, List, Sequence

import numpy as np
import torch

__all__ = ["SmoothedValue", "MetricLogger", "accuracy", "reduce_across_processes"]


class SmoothedValue:
    """A series with a smoothing window (median, average, max, last value)
    and its global average."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1) -> None:
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Named ``SmoothedValue`` meters, printed together."""

    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        """Yield the items of ``iterable``, printing the meters, the time an
        item and the ETA every ``print_freq`` items and the total at the end."""
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = datetime.timedelta(seconds=int(iter_time.global_avg * (total - i)))
                    print(f"{header} [{i}/{total}] eta: {eta} {self} time: {iter_time}")
                else:
                    print(f"{header} [{i}] {self} time: {iter_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}")


def accuracy(logits: torch.Tensor, targets: torch.Tensor, topk: Sequence[int] = (1,)) -> List[float]:
    """Top-k accuracies in percent of (N, classes) ``logits`` against (N,)
    integer ``targets``, ties ranked as ``jax.lax.top_k`` ranks them (the lower
    index first)."""
    maxk = max(topk)
    pred = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :maxk]
    correct = pred == targets[:, None]
    return [float(correct[:, :k].any(dim=1).sum()) / targets.shape[0] * 100.0 for k in topk]


def reduce_across_processes(value):
    """Sum ``value`` over the processes of ``torch.distributed`` (the
    reference's all-reduce); ``value`` as it is where no process group is
    initialised.  The sum comes back as a tensor on the process group's
    device (the CPU for gloo, the current card for NCCL)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return value
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else "cpu"
    t = torch.as_tensor(value, device=device).clone()
    dist.all_reduce(t)
    return t
