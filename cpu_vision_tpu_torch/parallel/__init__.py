"""Training steps (PyTorch).  Counterpart of the JAX package's ``parallel``,
so far its single-device ``make_train_step``; the mesh and the sharding
helpers are not ported yet."""

from .train_step import make_train_step  # noqa: F401
