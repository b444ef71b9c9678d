#!/usr/bin/env python3
"""How far a Swin-T and a ConvNeXt-T bf16 training step on the kernel routes stands from the same step on the plain
routes, sound and with one fault at a time put into the kernel routes' backward: the control of
``chip_smoke.py``'s rules SC_GRAD_L2 and SC_LOSS_TOL.

    python3 tools/torch_train_grad_control.py [--batch 128]

The card only.  For ``swin_t`` at its default stochastic depth (0.2) and at 0, and ``convnext_tiny`` at its
default (0.1) with the depthwise kernel, as ``chip_smoke.py``'s training phases take them (224², ``--batch``
images from numpy seed 4, weights from seed 0 with ConvNeXt's layer scales at 0.25, the stochastic depth from a
generator of seed 11, SGD with lr 0.1 and momentum 0.9), it runs three steps on the plain routes once and on the
kernel routes once sound and once under each fault, and prints one JSON line each: ||a - b|| / ||b|| of the first
gradients over all parameters and over those of the stem and of the blocks on the kernels, and the losses' gaps
|a - b| / (1 + |b|).  The faults, each patched into the kernel routes alone:

* ``dx_half``: the MLP blocks' dx product (``bf16_product``) halved;
* ``wgrad_half_rows``: the MLP blocks' weight gradients (``wgrad_matmul``) over the first half of the rows only;
* ``db1_zero``: the first MLP bias's gradient (``mlp_gelu_backward``) zeroed;
* ``ln_no_residual``: ``ln_backward_rows`` without the residual's gradient (Swin's blocks pass it);
* ``draw_ahead``: the stochastic depth drawn from the generator one draw ahead;
* ``dw_dx_unflipped``: the depthwise convolution's dx taken with the taps unflipped (ConvNeXt).

The card's name and power limit lead the output.  Exits 1 without a card.
"""

import argparse
import contextlib
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=128)
    batch = parser.parse_args().batch

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    from cpu_vision_tpu_torch import models, parallel
    from cpu_vision_tpu_torch.ops.kernels import depthwise, transformer_block

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.random((batch, 224, 224, 3), dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 1000, batch)).to(dev)

    @contextlib.contextmanager
    def patched(module, name, make):
        """``module.name`` replaced by ``make(module.name)``, which shares the wrapper's launch counts."""
        saved = getattr(module, name)
        faulty = make(saved)
        faulty.__dict__ = saved.__dict__
        setattr(module, name, faulty)
        try:
            yield
        finally:
            setattr(module, name, saved)

    def wgrad_half_rows(fn):
        return lambda x, dy: fn(x[: x.shape[0] // 2].contiguous(), dy[: dy.shape[0] // 2].contiguous())

    def db1_zero(fn):
        def call(*args):
            du, a, db1 = fn(*args)
            return du, a, torch.zeros_like(db1)
        return call

    def dw_dx_unflipped(fn):
        def call(args, grad, needs):
            dx, dk, db = fn(args, grad, needs)
            if needs[0]:
                dx = depthwise._kernel(grad.contiguous(), args[1], None)
            return dx, dk, db
        return call

    faults = {
        "sound": contextlib.nullcontext,
        "dx_half": lambda: patched(transformer_block, "bf16_product", lambda fn: lambda *a, **k: fn(*a, **k) * 0.5),
        "wgrad_half_rows": lambda: patched(transformer_block, "wgrad_matmul", wgrad_half_rows),
        "db1_zero": lambda: patched(transformer_block, "mlp_gelu_backward", db1_zero),
        "ln_no_residual": lambda: patched(transformer_block, "ln_backward_rows",
                                          lambda fn: lambda x, g, dh, resid=None, eps=1e-6: fn(x, g, dh, None, eps)),
        "draw_ahead": contextlib.nullcontext,
        "dw_dx_unflipped": lambda: patched(depthwise, "_backward", dw_dx_unflipped),
    }

    def run(name, state, kw, fault):
        model = models.get_model(name, dtype=torch.bfloat16, **kw)
        model.load_state_dict(state)
        gen = torch.Generator(device=dev).manual_seed(11)
        if fault == "draw_ahead":
            torch.rand(1, generator=gen, device=dev)

        def xent(m, b):
            return F.cross_entropy(m(b[0], train=True, generator=gen).float(), b[1]), {}

        step = parallel.make_train_step(xent, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9))
        losses, first = [], None
        with faults[fault]():
            for _ in range(3):
                losses.append(float(step(model, (images, labels))[0]))
                if first is None:
                    first = {n: p.grad.detach().double() for n, p in model.named_parameters()}
        blocks = [b for b, r in zip(model.blocks(), model.routes(batch, 224, 224, train=True) if name == "swin_t"
                                    else model.routes(train=True)) if r[0] == "block"]
        near = tuple(["features.0."] + [n + "." for n, m in model.named_modules() if any(m is b for b in blocks)])
        del model
        return losses, first, near

    def l2(got, want, keep):
        names = [n for n in want if keep(n)]
        return math.sqrt(sum(float((got[n] - want[n]).square().sum()) for n in names)
                         / sum(float(want[n].square().sum()) for n in names))

    swin_state = models.get_model("swin_t", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0)).state_dict()
    cn_state = models.get_model("convnext_tiny", dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0)).state_dict()
    for key in cn_state:
        if key.endswith("layer_scale"):
            cn_state[key].fill_(0.25)
    plain_swin = dict(attention="plain", mlp="plain")
    swin_faults = ("sound", "dx_half", "wgrad_half_rows", "db1_zero", "ln_no_residual", "draw_ahead")
    cases = [("swin_t sd 0.2", "swin_t", swin_state, {}, plain_swin, swin_faults),
             ("swin_t sd 0", "swin_t", swin_state, dict(sd_prob=0.0), dict(plain_swin, sd_prob=0.0), swin_faults),
             ("convnext_tiny sd 0.1", "convnext_tiny", cn_state, dict(depthwise="kernel"),
              dict(mlp="plain", depthwise="stock"),
              ("sound", "dx_half", "wgrad_half_rows", "db1_zero", "draw_ahead", "dw_dx_unflipped"))]
    for label, name, state, kernel_kw, plain_kw, which in cases:
        p_losses, p_first, _ = run(name, state, plain_kw, "sound")
        for fault in which:
            k_losses, k_first, near = run(name, state, kernel_kw, fault)
            print(json.dumps({
                "case": label, "batch": batch, "fault": fault,
                "l2_all": l2(k_first, p_first, lambda n: True),
                "l2_stem_and_kernel_blocks": l2(k_first, p_first, lambda n: n.startswith(near)),
                "loss_gaps": [abs(a - b) / (1 + abs(b)) for a, b in zip(k_losses, p_losses)],
                "losses": k_losses, "plain_losses": p_losses}), flush=True)
            del k_first
        del p_first
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
