"""Training utilities (PyTorch): metrics, model EMA and checkpoints.

Counterpart of the JAX package's ``train/`` without its ``presets``, which
wait for ``transforms``.
"""

from .checkpoint import load_checkpoint, load_params, save_checkpoint  # noqa: F401
from .ema import ExponentialMovingAverage  # noqa: F401
from .metrics import MetricLogger, SmoothedValue, accuracy  # noqa: F401
