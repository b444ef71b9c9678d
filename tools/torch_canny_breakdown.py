#!/usr/bin/env python3
"""Where the time of the PyTorch port's Canny goes on one NVIDIA card, and
Canny's kernels against an older tree's, in turns.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_canny_breakdown.py
    python3 tools/torch_canny_breakdown.py --old-tree DIR [--rounds N] [--json PATH]

Both print the card's name and power limit first.  Without ``--old-tree``,
for ``ops.canny`` on the headline scene (1080p, batch 8, thresholds 0.1/0.2)
it prints:

* how many hysteresis sweeps the scene needs to reach its fixpoint;
* for several (sweeps per pass, passes per host check) settings of the
  fixpoint, on the scene and on uniform noise (thresholds 0.3/0.6, tens of
  sweeps to the fixpoint): passes launched, host flag reads, device time of
  one pass, and the time of the whole ``ops.canny`` call from CUDA events;
* the same Canny with ``canny_stage1``'s in-tile hysteresis off and on, on
  the scene and on noise: time of stage 1, global passes launched, time of
  one pass and of the whole pipeline;
* a ``torch.profiler`` table of device time by kernel over 5 calls at the
  package's own settings.

``--old-tree`` is the root of an older checkout (a ``git archive`` of its
``cpu_vision_tpu_torch`` unpacked under ``build/``; its C interface of
``cvt_canny_stage1`` and ``cvt_hysteresis_sweeps`` as at commit 2be2e85, or
this one's).  Its ``stencil.cu`` is built with its own headers and flags, and
its ``ops/kernels/stencil.py`` (wrappers and fixpoint loop, with its own
``SWEEPS_PER_PASS`` and ``PASSES_PER_CHECK``) is loaded beside this tree's,
on its library.  On the scene it times ``canny_stage1`` (row 2),
``hysteresis_sweeps`` at 4 sweeps (row 3) and the ``ops.canny`` call of
either tree in ``--rounds`` rounds of 20 calls, the order reversed every
other round, and takes the least of each; it checks that both trees' class
maps, swept maps and edges equal the twins' bit for bit (on the scene and on
noise) and prints the passes launched and the host's flag reads of a call.
One line a case and a JSON line of every figure (also written to ``--json``);
exits 1 if a check fails.  No test imports it.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from chip_smoke import scene, time_ms  # noqa: E402
from cpu_vision_tpu_torch import ops  # noqa: E402
from cpu_vision_tpu_torch.ops import kernels  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import _build, stencil  # noqa: E402

SETTINGS = [(2, 1), (4, 1), (4, 2), (8, 1), (8, 2), (16, 1)]
H, W, B = 1080, 1920, 8  # the headline scene
HBM_BYTES_PER_S = 3.35e12


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def canny_pipeline(x: torch.Tensor, low: float, high: float, in_tile: bool) -> torch.Tensor:
    """``kernels.fused_canny`` with stage 1's in-tile hysteresis off or on."""
    maps, restore = stencil._gray_maps(x)
    cls = stencil._canny_stage1(maps, *stencil._canny_taps(5, 1.4), low, high, in_tile=in_tile)
    return restore((kernels.hysteresis_fixpoint(cls) == 2).to(torch.float32))


def passes_and_reads(fn):
    """(passes launched, host flag reads) of one call of ``fn``."""
    kernels.reset_launch_counts()
    fn()
    return kernels.launch_counts()["hysteresis_sweeps"], stencil.hysteresis_fixpoint.host_reads


def breakdown() -> int:
    x = torch.from_numpy(scene(H, W, B)).cuda()
    noise = torch.from_numpy(np.random.default_rng(0).random((B, H, W, 1), dtype=np.float32)).cuda()
    cls = kernels.canny_stage1(x[..., 0].contiguous(), 0.1, 0.2)

    cur, sweeps = cls, 0
    while True:
        nxt = kernels.hysteresis_sweeps(cur, 1)
        sweeps += 1
        if torch.equal(nxt, cur):
            break
        cur = nxt
    print(f"hysteresis sweeps to the fixpoint, the unchanged one included: {sweeps}")

    default = stencil.SWEEPS_PER_PASS, stencil.PASSES_PER_CHECK
    try:
        for name, img, low, high in (("scene", x, 0.1, 0.2), ("noise", noise, 0.3, 0.6)):
            for spp, ppc in SETTINGS:
                stencil.SWEEPS_PER_PASS, stencil.PASSES_PER_CHECK = spp, ppc
                passes, reads = passes_and_reads(lambda: ops.canny(img, low, high))
                pass_ms = time_ms(lambda: kernels.hysteresis_sweeps(cls, spp), 20)
                canny_ms = time_ms(lambda: ops.canny(img, low, high), 20)
                print(f"{name}: sweeps/pass {spp:2d}, passes/check {ppc}: {passes} passes, {reads} host reads, "
                      f"one pass {pass_ms:.4f} ms, ops.canny {canny_ms:.4f} ms")
    finally:
        stencil.SWEEPS_PER_PASS, stencil.PASSES_PER_CHECK = default

    pass_ms = time_ms(lambda: kernels.hysteresis_sweeps(cls, default[0]), 20)
    for name, img, low, high in (("scene", x, 0.1, 0.2), ("noise", noise, 0.3, 0.6)):
        maps = img[..., 0].contiguous()
        edges = {}
        for in_tile in (False, True):
            passes, _ = passes_and_reads(lambda: edges.__setitem__(in_tile, canny_pipeline(img, low, high, in_tile)))
            stage1_ms = time_ms(lambda: kernels.canny_stage1(maps, low, high, in_tile_hysteresis=in_tile), 20)
            total_ms = time_ms(lambda: canny_pipeline(img, low, high, in_tile), 20)
            print(f"{name}, in-tile hysteresis {'on ' if in_tile else 'off'}: stage 1 {stage1_ms:.4f} ms, "
                  f"{passes} passes of {pass_ms:.4f} ms, whole Canny {total_ms:.4f} ms")
        if not torch.equal(edges[False], edges[True]):
            raise AssertionError(f"{name}: the in-tile option changed the edges")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ops.canny(x, 0.1, 0.2)
        torch.cuda.synchronize()
    print(f"settings: sweeps/pass {default[0]}, passes/check {default[1]}")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12))
    return 0


# ------------------------------------------------------------------ --old-tree


def load_older(tree: Path):
    """The older tree's ``stencil.py`` as a module on its own ``stencil.cu`` (built here), beside this tree's."""
    csrc = tree / "cpu_vision_tpu_torch" / "csrc"
    out = REPO / "build" / "canny_ab"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libstencil_old.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS["stencil"], "-I", str(csrc), "-o", str(lib),
           str(csrc / "stencil.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the older stencil.cu:\n{proc.stdout}{proc.stderr}")
    older_lib = ctypes.CDLL(str(lib))

    class OlderBuild:
        """This tree's ``_build`` with the older library in place of this tree's."""

        def __getattr__(self, name):
            return getattr(_build, name)

        @staticmethod
        def load(stem):
            assert stem == "stencil", stem
            return older_lib

    name = "cpu_vision_tpu_torch.ops.kernels._older_stencil"
    spec = importlib.util.spec_from_file_location(name, tree / "cpu_vision_tpu_torch" / "ops" / "kernels" / "stencil.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)  # its helpers (filters, edges, _build) resolve to this tree's, unchanged
    module._build = OlderBuild()
    return module


def device_ms(fn, calls: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def in_turns(fns: dict, rounds: int, calls: int) -> dict:
    """{name: [ms of each round]}, the order of ``fns`` reversed every other round."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(device_ms(fns[name], calls))
    return times


def with_older_canny(older, fn):
    """``fn`` with ``ops.canny``'s kernel route on the older tree's ``fused_canny``."""

    def run():
        saved = kernels.fused_canny
        kernels.fused_canny = older.fused_canny
        try:
            return fn()
        finally:
            kernels.fused_canny = saved

    return run


def against_older(tree: Path, rounds: int, json_path: Path, card: str) -> int:
    older = load_older(tree)
    faults, cases = [], []
    x = torch.from_numpy(scene(H, W, B)).cuda()
    noise = torch.from_numpy(np.random.default_rng(0).random((B, H, W, 1), dtype=np.float32)).cuda()
    px = x.numel()
    taps = stencil.gaussian_taps(5, 1.4)

    for what, img, low, high in (("scene", x, 0.1, 0.2), ("noise", noise, 0.3, 0.6)):
        maps = img[..., 0].contiguous()
        cls = kernels.canny_stage1(maps, low, high)
        twin_cls = stencil.canny_stage1_plain(maps, taps, low, high)
        swept, twin_swept = kernels.hysteresis_sweeps(cls, 4), stencil.hysteresis_sweeps_plain(cls, 4)
        edges = ops.canny(img, low, high)
        twin_cls_op = stencil.canny_stage1_plain(maps, stencil._canny_taps(5, 1.4)[0], low, high)
        twin_edges = ops.hysteresis(twin_cls_op == 2, twin_cls_op >= 1).to(torch.float32)[..., None]
        checks = {
            "canny_stage1 equals the twin": torch.equal(cls, twin_cls),
            "older canny_stage1 equals the twin": torch.equal(older.canny_stage1(maps, low, high), twin_cls),
            "hysteresis_sweeps x4 equals the twin": torch.equal(swept, twin_swept),
            "older hysteresis_sweeps x4 equals the twin": torch.equal(older.hysteresis_sweeps(cls, 4), twin_swept),
            "ops.canny equals the twin path": torch.equal(edges, twin_edges),
            "older ops.canny equals the twin path": torch.equal(with_older_canny(older, lambda: ops.canny(img, low, high))(),
                                                                twin_edges),
        }
        faults += [f"{what}: {k}" for k, v in checks.items() if not v]
        passes, reads = passes_and_reads(lambda: ops.canny(img, low, high))
        older.hysteresis_sweeps.launches = 0
        with_older_canny(older, lambda: ops.canny(img, low, high))()
        older_passes = older.hysteresis_sweeps.launches
        print(f"{what}: {checks}; passes a call {passes} ({reads} host reads), older tree {older_passes}")
        if what != "scene":
            cases.append(dict(case=f"bits and passes, {what}", checks=checks, passes=passes, host_reads=reads,
                              older_passes=older_passes))
            continue
        buf = torch.empty_like(cls)
        rows = [
            ("canny_stage1 (row 2) 8x1080x1920", lambda: kernels.canny_stage1(maps, low, high),
             lambda: older.canny_stage1(maps, low, high), px * 5),
            ("hysteresis_sweeps x4 (row 3) 8x1080x1920", lambda: kernels.hysteresis_sweeps(cls, 4, out=buf),
             lambda: older.hysteresis_sweeps(cls, 4, out=buf), px * 2),
            ("ops.canny 1080p b8", lambda: ops.canny(img, low, high),
             with_older_canny(older, lambda: ops.canny(img, low, high)), px * 8),
        ]
        for name, new_fn, old_fn, nbytes in rows:
            times = in_turns({"ms": new_fn, "older_ms": old_fn}, rounds, 20)
            row = dict(case=name, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                       **{k: min(v) for k, v in times.items()}, rounds=times)
            if name.startswith("ops.canny"):
                row.update(gpix_s=px / row["ms"] / 1e6, older_gpix_s=px / row["older_ms"] / 1e6, passes=passes,
                           host_reads=reads, older_passes=older_passes, checks=checks)
            print(f"{name}: {row['ms']:.4f} ms, older tree {row['older_ms']:.4f} ms (least of {rounds} rounds: "
                  f"{['%.4f' % t for t in times['ms']]} against {['%.4f' % t for t in times['older_ms']]}); "
                  f"bound {row['bound_ms']:.4f} ms (bytes)"
                  + (f"; {row['gpix_s']:.2f} GPix/s against {row['older_gpix_s']:.2f}" if "gpix_s" in row else ""))
            cases.append(row)
    summary = {"card": card, "settings": [stencil.SWEEPS_PER_PASS, stencil.PASSES_PER_CHECK],
               "older_settings": [older.SWEEPS_PER_PASS, older.PASSES_PER_CHECK], "cases": cases, "failures": faults}
    json_path.parent.mkdir(parents=True, exist_ok=True)
    json_path.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if faults:
        print(f"FAILED: {faults}", file=sys.stderr)
    return 1 if faults else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-tree", help="root of an older checkout, under build/: time against it in turns")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", default=str(REPO / "build" / "canny_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_canny_breakdown: no CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    if args.old_tree:
        return against_older(Path(args.old_tree).resolve(), args.rounds, Path(args.json), card)
    return breakdown()


if __name__ == "__main__":
    sys.exit(main())
