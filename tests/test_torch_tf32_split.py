"""The arithmetic of split TF32 (3xTF32, ``csrc/tf32x3.cuh``) modelled in torch on
the CPU, against float64.

The kernels write a float32 operand as ``a = a_hi + a_lo`` with ``a_hi =
rna(a)``, where ``rna`` rounds to the nearest tf32 (11 significant bits, ties
away from zero: ``cvt.rna.tf32.f32``), and ``a_lo = a - a_hi`` (exact), and sum
``a_hi·b_hi + a_hi·b_lo + a_lo·b_hi`` in float32; the tensor cores read each
operand with its 13 low mantissa bits dropped, so ``a_lo`` is truncated to tf32
there.  Each stage of 32 terms is summed
on its own and added into a float32 sum (the kernels' promotion), and the
weight gradient's sums run in slabs of rows added in slab order, as
``ops/kernels/wgrad_matmul.py`` sizes them.

Modelled here with bit operations on float32 words: the rounding, the
truncation, the dropped ``a_lo·b_lo`` term, and the sums at the main paths'
contractions (K = 768 and 3072 of the MLP products, K = 401,408 rows of the
weight gradient).  The rule is the card's (``chip_smoke.py``): the split sum
stands no further from the float64 sum than twice a plain float32 sum of the
same terms in the same blocks (float32 products, float32 sums).  A sum of one
tf32 product per term (TF32 as such) fails that rule, so the rule can fail.
"""

import math

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops.kernels.wgrad_matmul import slab_rows

STAGE = 32  # terms a stage (X3_BK)
LOW = 0x1FFF  # the 13 mantissa bits a tf32 operand drops


def rna(x: torch.Tensor) -> torch.Tensor:
    """float32 to the nearest tf32, ties away from zero, as ``cvt.rna.tf32.f32``."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~LOW).view(torch.float32)


def read_by_the_hardware(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of a float32 word as a tf32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~LOW).view(torch.float32)


def split(x: torch.Tensor, round_hi: bool = True):
    hi = rna(x) if round_hi else x
    return hi, x - hi


def blocked_sum(terms: torch.Tensor, slab: int) -> torch.Tensor:
    """float32 sum over dim 0 of ``terms`` (K, ...): each stage of ``STAGE`` terms summed alone, the
    stages added in order into a slab's sum, the slabs' sums added in order."""
    k = terms.shape[0]
    total = torch.zeros(terms.shape[1:], dtype=torch.float32)
    for s0 in range(0, k, slab):
        part = terms[s0 : s0 + slab]
        pad = -part.shape[0] % STAGE
        if pad:
            part = torch.cat([part, part.new_zeros((pad, *part.shape[1:]))])
        stages = part.reshape(-1, STAGE, *part.shape[1:]).sum(dim=1, dtype=torch.float32)
        acc = torch.zeros_like(total)
        for stage in stages:
            acc = acc + stage
        total = total + acc
    return total


def products(a: torch.Tensor, b: torch.Tensor, how: str) -> torch.Tensor:
    """(K, r, c) float32 terms of ``a.T @ b`` for a (K, r), b (K, c): ``plain`` a·b rounded to float32,
    ``split`` the three split products of the operands as the hardware reads them (each exact in
    float32) summed in float32 in the kernels' order, ``split_unrounded_hi`` the same with a_hi
    not rounded, ``tf32`` one product of the operands as the hardware reads them."""
    a3, b3 = a[:, :, None], b[:, None, :]
    if how == "plain":
        return a3 * b3
    if how == "tf32":
        return read_by_the_hardware(a3.expand(-1, -1, b.shape[1])) * read_by_the_hardware(b3.expand(-1, a.shape[1], -1))
    ah, al = split(a, round_hi=how == "split")
    bh, bl = split(b, round_hi=how == "split")
    ah, al, bh, bl = (read_by_the_hardware(t) for t in (ah, al, bh, bl))
    ah, al, bh, bl = ah[:, :, None], al[:, :, None], bh[:, None, :], bl[:, None, :]
    return (al * bh + ah * bl) + ah * bh


def f64_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.double() - ref).abs().max() / ref.abs().max())


def test_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # a tf32 step at 1
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2.0 ** -23, -(one + ulp / 2), one + 1.5 * ulp, 3.0, 0.0],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp, 3.0, 0.0], dtype=torch.float32)
    assert torch.equal(rna(x), want)
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(10_000) * 10.0 ** rng.integers(-6, 6, 10_000)).astype(np.float32))
    r = rna(v)
    assert torch.equal(read_by_the_hardware(r), r)  # the low bits are zero: the hardware reads what was rounded
    exp = torch.floor(torch.log2(v.abs().double()))
    step = torch.pow(2.0, exp - 10)
    assert bool(((r.double() - v.double()).abs() <= step / 2).all())  # nearest: within half a tf32 step


def test_split_leaves_out_about_2e_20_of_each_product():
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.standard_normal(100_000).astype(np.float32)) for _ in range(2))
    (ah, al), (bh, bl) = split(a), split(b)
    assert torch.equal(ah + al, a)  # the rest is exact in float32
    assert bool(((al.double()).abs() <= 2.0 ** -11 * a.double().abs()).all())
    al_t, bl_t = read_by_the_hardware(al).double(), read_by_the_hardware(bl).double()
    assert bool(((al.double() - al_t).abs() <= 2.0 ** -21 * a.double().abs()).all())  # the truncated rest
    exact = a.double() * b.double()
    three = ah.double() * bh.double() + ah.double() * bl_t + al_t * bh.double()
    lo_lo = al.double() * bl.double()
    assert bool((lo_lo.abs() <= 2.0 ** -22 * exact.abs()).all())  # the dropped lo·lo term
    assert bool(((three - exact).abs() <= 1.3 * 2.0 ** -20 * exact.abs()).all())
    one = (read_by_the_hardware(a).double() * read_by_the_hardware(b).double() - exact).abs() / exact.abs()
    assert float(one.max()) > 2.0 ** -11  # one tf32 product keeps no more than TF32's 11 bits


def _sums(k: int, slab: int, seed: int, r: int = 4, c: int = 4):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((k, r)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, c)).astype(np.float32))
    ref = a.double().t() @ b.double()
    return {how: f64_err(blocked_sum(products(a, b, how), slab), ref)
            for how in ("plain", "split", "split_unrounded_hi", "tf32")}


@pytest.mark.parametrize("k,cin,cout", [(768, 0, 0), (3072, 0, 0), (401408, 64, 64)],
                         ids=["mlp_up_k768", "mlp_down_k3072", "wgrad_resnet50_layer1"])
def test_split_sum_is_as_near_float64_as_a_float32_sum(k, cin, cout):
    slab = slab_rows(k, cin, cout, 132) if cin else k  # the weight gradient's slabs on an H100's 132 SMs
    if cin:
        assert math.ceil(k / slab) > 1
    errs = _sums(k, slab, seed=k)
    assert errs["split"] <= 2 * errs["plain"], errs
    assert errs["tf32"] > 2 * errs["plain"], errs  # TF32 alone fails the rule
    assert errs["split_unrounded_hi"] > 2 * errs["plain"], errs  # so does a hi half left to the hardware's truncation
