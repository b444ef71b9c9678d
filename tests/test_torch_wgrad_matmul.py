"""The port's ``wgrad_matmul`` (``cpu_vision_tpu_torch.ops.kernels.wgrad_matmul``)
against the JAX package's Pallas kernel run in interpret mode, on the same
numpy inputs, at the JAX test's shapes (``tests/test_pointwise_conv.py``).

On CPU tensors the wrapper runs its plain twin.  Both sides sum float32
products (a product of two bfloat16 values is exact in float32) over M rows in
other orders: the results agree within ``1e-5·max|ref|``.  The CUDA kernel is
held against the twin on the card by ``test_torch_cuda.py``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpu_vision_tpu.ops.pallas.wgrad_matmul import wgrad_matmul as jwgrad
from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels.wgrad_matmul import CHUNK, MIN_SLAB_ROWS, TILE, slab_rows, wgrad_matmul_plain

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# ResNet-50 b128's 1x1 convolutions with at least 16,384 rows: (M, Cin, Cout)
RESNET50_B128 = [(401408, 64, 64), (401408, 64, 256), (401408, 256, 64), (401408, 256, 128),
                 (100352, 128, 512), (100352, 512, 128), (100352, 256, 512), (100352, 512, 256),
                 (25088, 256, 1024), (25088, 1024, 256), (25088, 512, 1024), (25088, 1024, 512)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,cin,cout", [(4096, 64, 64), (3000, 100, 60), (2048, 256, 64)])
def test_twin_matches_pallas_interpret(rng, m, cin, cout, dtype):
    x = rng.standard_normal((m, cin)).astype(np.float32)
    dy = rng.standard_normal((m, cout)).astype(np.float32)
    ref = np.asarray(jwgrad(jnp.asarray(x, JDT[dtype]), jnp.asarray(dy, JDT[dtype]), interpret=True))
    tx, tdy = torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(dy).to(TDT[dtype])
    out = kernels.wgrad_matmul(tx, tdy)
    assert out.shape == (cin, cout) and out.dtype == torch.float32  # no padding shows
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert torch.equal(out, wgrad_matmul_plain(tx, tdy))
    assert kernels.launch_counts()["wgrad_matmul"] == 0  # CPU tensors launch nothing


def test_refuses_what_the_kernel_does_not_take():
    x, dy = torch.zeros(8, 4), torch.zeros(8, 3)
    with pytest.raises(TypeError):
        kernels.wgrad_matmul(x, dy.to(torch.bfloat16))
    with pytest.raises(TypeError):
        kernels.wgrad_matmul(x.double(), dy.double())
    with pytest.raises(ValueError):
        kernels.wgrad_matmul(x, dy[:7])
    with pytest.raises(ValueError):
        kernels.wgrad_matmul(x[:0], dy[:0])


@pytest.mark.parametrize("m,cin,cout", RESNET50_B128 + [(1, 3, 5), (16383, 65, 129), (1000, 64, 64)])
def test_slabs_fill_the_card(m, cin, cout):
    sms = 132  # an H100 SXM
    rows = slab_rows(m, cin, cout, sms)
    slabs = math.ceil(m / rows)
    tiles = math.ceil(cin / TILE) * math.ceil(cout / TILE)
    assert rows % CHUNK == 0 and (slabs - 1) * rows < m <= slabs * rows  # every slab holds rows
    assert rows >= min(MIN_SLAB_ROWS, math.ceil(m / CHUNK) * CHUNK)
    if m >= 16384:  # the kernel's domain in conv1x1: at least two blocks an SM
        assert tiles * slabs >= 2 * sms
