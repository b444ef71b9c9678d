#!/usr/bin/env python3
"""Rows 4, 6 and 8 of the PyTorch port, ``fused_blur_sobel``,
``fused_gaussian_blur`` and ``nms_sorted``, against an older tree's, in turns,
on one NVIDIA card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/torch_blur_nms_ab.py --old-tree DIR [--rounds N] [--json PATH] [--cases blur_sobel,blur,nms]

``--old-tree`` is the root of an older checkout (a ``git archive`` of its
``cpu_vision_tpu_torch`` unpacked under ``build/``).  Its ``stencil.cu`` and
``nms.cu`` are built with its own headers and this tree's flags (this tree's
libraries at the same time, their ``ptxas`` reports for the blur's and
blur + Sobel's kernels at K 5 and the NMS's printed), and its
``ops/kernels/stencil.py`` and ``ops/kernels/nms.py`` are loaded beside this
tree's, on those libraries, so each tree's wrapper drives its own C
interface.  It prints the card's name and power limit first, then:

* ``fused_blur_sobel`` (K 5, sigma 1.5) at 512x512 and at the headline scene
  8x1080x1920x1, timed as the blur below; both trees' outputs must equal the
  twin bit for bit there and, at 1080p b8, at K 3, 7 and 9;
* ``fused_gaussian_blur`` (K 5, sigma 1.5) at 64x480x640x3 and at the
  headline scene 8x1080x1920x1: either tree's wrapper in ``--rounds`` rounds
  of 20 calls, the order reversed every other round, the least of each; the
  device time of each launch a call makes apart (``torch.profiler``: the
  kernel and any copy around it); the bytes bound.  Both trees' outputs must
  equal the twin bit for bit there and at C 4 and C 2;
* ``nms_sorted`` on the three inputs of one float32 Faster R-CNN forward
  (``fasterrcnn_resnet50_fpn`` b8 on a 640x640 canvas, ``chip_smoke.py``'s
  weights and images), timed the same way, each launch apart, and at
  (8, 300) the wrapper's host time a call beside the host time of its
  set-up alone (the float32 copy and the two ``torch.empty``) and of this
  tree's launch alone (the ctypes call of two kernels); both trees'
  keep masks must equal ``nms_sorted_plain``'s bit for bit there, on dense
  overlaps at (8, 4096) and at N 333;
* the float32 detector's ``detect`` of the 8 images with its three NMS
  calls on either tree's kernel, in turns (CUDA events around single calls,
  5 a round), its detections equal on both trees and on the plain NMS route.

``--cases`` runs some of the three groups (all by default).  One line a case
and a JSON line of every figure (also written to ``--json``); exits 1 if a
check fails.  No test imports it.
"""

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from chip_smoke import DET_CLS_SCALE, DET_SETTINGS, scene  # noqa: E402
from cpu_vision_tpu_torch import models  # noqa: E402
from cpu_vision_tpu_torch.ops import boxes as boxes_ops  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import _build, stencil  # noqa: E402
from cpu_vision_tpu_torch.ops.kernels import nms as nms_kernel  # noqa: E402
from torch_canny_breakdown import card_line, device_ms, in_turns  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
STEMS = ("stencil", "nms")
DET_SIZES = [(480, 640), (640, 427), (512, 512), (427, 640), (640, 480), (375, 500), (500, 375), (640, 640)]


def ptxas_lines(logs: dict) -> list:
    """The registers, shared memory and spills ``ptxas`` reports for the blur's and blur + Sobel's kernels at K 5 and
    the NMS's."""
    lines, fn = [], ""
    for stem in STEMS:
        for line in logs.get(stem, "").splitlines():
            named = re.search(r"Compiling entry function '(\S+)'", line)
            fn = named.group(1) if named else fn
            if (any(k in fn for k in ("blur_strip_kernelILi5E", "blur_sobel_strip_kernelILi5E", "nms_"))
                    and ("Used" in line or "spill" in line)):
                lines.append(f"{stem}: {fn}: {line.strip()}")
    return lines


def load_older(tree: Path):
    """The older tree's ``stencil.py`` and ``nms.py`` as modules on its own sources (built here), beside this
    tree's; this tree's libraries are built at the same time (``ptxas`` reports printed)."""
    logs = {}
    current = threading.Thread(target=lambda: logs.update(_build.build(ptxas_verbose=True)))
    current.start()
    csrc = tree / "cpu_vision_tpu_torch" / "csrc"
    out = REPO / "build" / "blur_nms_ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for stem in STEMS:
        lib = out / f"lib{stem}_old.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS[stem], "-I", str(csrc), "-o", str(lib),
               str(csrc / f"{stem}.cu")]
        jobs[stem] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for stem, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the older {stem}.cu:\n{log}")
        libs[stem] = ctypes.CDLL(str(lib))
    current.join()
    for line in ptxas_lines(logs):
        print(f"  {line}")

    class OlderBuild:
        """This tree's ``_build`` with the older libraries in place of this tree's."""

        def __getattr__(self, name):
            return getattr(_build, name)

        @staticmethod
        def load(stem):
            return libs[stem]

    modules = []
    for stem in STEMS:
        name = f"cpu_vision_tpu_torch.ops.kernels._older_{stem}"
        spec = importlib.util.spec_from_file_location(name, tree / "cpu_vision_tpu_torch" / "ops" / "kernels" / f"{stem}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)  # its helpers resolve to this tree's
        module._build = OlderBuild()
        modules.append(module)
    return modules


def launches_apart(fn, calls: int = 5):
    """[(kernel or copy, launches a call, device ms a call)] of one call of ``fn``, from the profiler's device
    intervals over ``calls`` calls.  A sleeping kernel leads the window (the profiler may miss the first kernels
    after it starts) and is left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or "sleep" in e.name:
            continue
        n, us = by_name.get(e.name[:120], (0, 0.0))
        by_name[e.name[:120]] = (n + 1, us + e.time_range.end - e.time_range.start)
    return [(name, n / calls, us / calls / 1e3) for name, (n, us) in by_name.items()]


def host_ms(fn, calls: int = 200) -> float:
    """The host's time a call of ``fn`` (enqueue only; the card is synchronised before and after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e3


def timed_pair(name, new_fn, old_fn, rounds, nbytes=None, calls=20):
    times = in_turns({"ms": new_fn, "older_ms": old_fn}, rounds, calls)
    row = dict(case=name, **{k: min(v) for k, v in times.items()}, rounds=times,
               launches=launches_apart(new_fn), older_launches=launches_apart(old_fn))
    if nbytes is not None:
        row.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    print(f"{name}: {row['ms']:.4f} ms, older tree {row['older_ms']:.4f} ms (least of {rounds} rounds: "
          f"{['%.4f' % t for t in times['ms']]} against {['%.4f' % t for t in times['older_ms']]})"
          + (f"; bound {row['bound_ms']:.4f} ms (bytes)" if nbytes is not None else ""))
    for label, key in (("this tree", "launches"), ("older tree", "older_launches")):
        print(f"  {label}, device ms a call by launch: "
              + "; ".join(f"{n} x {k}: {ms:.4f}" for k, n, ms in row[key]))
    return row


def blur_sobel_cases(older_stencil, rounds, faults):
    """Row 4 at 512x512 and 1080p b8: both trees bit for bit against the twin (at 1080p also at K 3, 7, 9), timed."""
    images = {"512x512": torch.from_numpy(np.random.default_rng(0).random((512, 512), dtype=np.float32)).cuda(),
              "8x1080x1920x1": torch.from_numpy(scene(1080, 1920, 8)).cuda()}
    cases = []
    for name, img in images.items():
        maps, restore = stencil._as_nhw(img)
        checks = {}
        for ks in (5,) if name == "512x512" else (5, 3, 7, 9):
            twin = restore(stencil.fused_blur_sobel_plain(maps, stencil.gaussian_taps(ks, 1.5)))
            checks[f"K {ks} equals the twin"] = torch.equal(stencil.fused_blur_sobel(img, ks, 1.5), twin)
            checks[f"K {ks} older equals the twin"] = torch.equal(older_stencil.fused_blur_sobel(img, ks, 1.5), twin)
        faults += [f"fused_blur_sobel {name}: {k}" for k, v in checks.items() if not v]
        print(f"fused_blur_sobel {name}: {checks}")
        row = timed_pair(f"fused_blur_sobel (row 4) {name}", lambda: stencil.fused_blur_sobel(img),
                         lambda: older_stencil.fused_blur_sobel(img), rounds, img.numel() * 8)
        cases.append(dict(row, checks=checks))
        del maps, twin
    return cases


def blur_cases(older_stencil, rounds, faults):
    rng = np.random.default_rng(0)
    taps = stencil.gaussian_taps(5, 1.5)
    cases = []
    images = {
        "64x480x640x3": torch.from_numpy(rng.random((64, 480, 640, 3), dtype=np.float32)).cuda(),
        "8x1080x1920x1": torch.from_numpy(scene(1080, 1920, 8)).cuda(),
        "8x480x640x4": torch.from_numpy(rng.random((8, 480, 640, 4), dtype=np.float32)).cuda(),
        "4x200x301x2 (the maps route)": torch.from_numpy(rng.random((4, 200, 301, 2), dtype=np.float32)).cuda(),
    }
    for name, img in images.items():
        maps, restore = stencil._as_nhw(img)
        twin = restore(stencil.fused_gaussian_blur_plain(maps, taps))
        out, older_out = stencil.fused_gaussian_blur(img), older_stencil.fused_gaussian_blur(img)
        checks = {"equals the twin": torch.equal(out, twin), "older equals the twin": torch.equal(older_out, twin),
                  "contiguous NHWC": out.is_contiguous(), "older contiguous NHWC": older_out.is_contiguous()}
        faults += [f"fused_gaussian_blur {name}: {k}" for k, v in checks.items() if not v and "contiguous" not in k]
        print(f"fused_gaussian_blur {name}: {checks}")
        del maps, twin, out, older_out
        if name.startswith(("64x", "8x1080")):
            row = timed_pair(f"fused_gaussian_blur (row 6) {name}", lambda: stencil.fused_gaussian_blur(img),
                             lambda: older_stencil.fused_gaussian_blur(img), rounds, img.numel() * 8)
            cases.append(dict(row, checks=checks))
        else:
            cases.append(dict(case=f"fused_gaussian_blur bits {name}", checks=checks))
    return cases


def detector_inputs():
    """The float32 Faster R-CNN of ``chip_smoke.py`` (bf16 weights from seed 0, class scores scaled, carried to
    float32), its 8 images, and the (boxes, threshold) of its three ``nms_sorted`` calls."""
    from cpu_vision_tpu_torch.models import detection

    name = "fasterrcnn_resnet50_fpn"
    bf16 = models.get_model(name, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0), **DET_SETTINGS)
    with torch.no_grad():
        bf16.roi_heads.box_predictor.cls_score.weight.mul_(DET_CLS_SCALE[name])
    model = models.get_model(name, dtype=torch.float32, generator=torch.Generator().manual_seed(0), **DET_SETTINGS)
    model.load_state_dict(bf16.state_dict())
    del bf16
    det_rng = np.random.default_rng(2)
    images = [torch.from_numpy(det_rng.random((hh, ww, 3), dtype=np.float32)).cuda() for hh, ww in DET_SIZES]
    with nms_kernel.recording() as calls:
        model(detection.GeneralizedRCNNTransform(min_size=320, max_size=640)(images)[0])
    return model, images, [(b, float(thr)) for b, thr in calls]


def with_older_nms(older_nms, fn):
    """``fn`` with ``ops.boxes.nms``'s kernel route on the older tree's ``nms.py``."""

    def run():
        saved = boxes_ops._nms_kernel
        boxes_ops._nms_kernel = older_nms
        try:
            return fn()
        finally:
            boxes_ops._nms_kernel = saved

    return run


def nms_cases(older_nms, rounds, faults):
    from cpu_vision_tpu_torch.models import detection

    model, images, calls = detector_inputs()
    gen = torch.Generator(device="cuda").manual_seed(5)
    crowd_ctr = torch.rand((8, 4096, 2), generator=gen, device="cuda") * 80
    crowd_wh = torch.rand((8, 4096, 2), generator=gen, device="cuda") * 40 + 5
    odd = torch.rand((3, 333, 4), generator=gen, device="cuda") * 50
    extra = [(torch.cat([crowd_ctr - crowd_wh / 2, crowd_ctr + crowd_wh / 2], -1), 0.5, "dense overlaps"),
             (torch.cat([odd[..., :2], odd[..., :2] + odd[..., 2:] + 1], -1), 0.7, "N 333")]
    cases = []
    for boxes, thr, what in [(b, t, "the f32 detector's boxes") for b, t in calls] + extra:
        twin = nms_kernel.nms_sorted_plain(boxes, thr)
        keep, older_keep = nms_kernel.nms_sorted(boxes, thr), older_nms.nms_sorted(boxes, thr)
        checks = {"equals the twin": torch.equal(keep, twin), "older equals the twin": torch.equal(older_keep, twin)}
        faults += [f"nms_sorted {list(boxes.shape)} {what}: {k}" for k, v in checks.items() if not v]
        name = f"nms_sorted (row 8) {list(boxes.shape)} thr {thr}, {what}"
        print(f"{name}: kept {int(keep.sum())}; {checks}")
        if what != "the f32 detector's boxes":
            cases.append(dict(case=name, checks=checks, kept=int(keep.sum())))
            continue
        row = timed_pair(name, lambda: nms_kernel.nms_sorted(boxes, thr), lambda: older_nms.nms_sorted(boxes, thr),
                         rounds)
        row.update(checks=checks, kept=int(keep.sum()))
        if boxes.shape[1] == 300:
            p, n = boxes.shape[0], boxes.shape[1]
            setup = lambda: (boxes.float().reshape(p, n, 4).contiguous(),  # noqa: E731
                             torch.empty((p, n), dtype=torch.bool, device=boxes.device),
                             torch.empty((p, nms_kernel.mask_words(n)), dtype=torch.int64, device=boxes.device))
            b, keep_buf = boxes.float().contiguous(), torch.empty((p, n), dtype=torch.bool, device=boxes.device)
            mask = torch.empty((p, nms_kernel.mask_words(n)), dtype=torch.int64, device=boxes.device)
            launch = lambda: _build.launch(nms_kernel._lib(), "cvt_nms_sorted", b, b.data_ptr(),  # noqa: E731
                                           mask.data_ptr(), keep_buf.data_ptr(), p, n, thr, _build.sm_count(b))
            row.update(host_ms=host_ms(lambda: nms_kernel.nms_sorted(boxes, thr)),
                       older_host_ms=host_ms(lambda: older_nms.nms_sorted(boxes, thr)), setup_host_ms=host_ms(setup),
                       launch_host_ms=host_ms(launch))
            print(f"  host ms a call: this tree {row['host_ms']:.4f}, older tree {row['older_host_ms']:.4f}, the "
                  f"set-up alone (float copy, two torch.empty) {row['setup_host_ms']:.4f}, the launch alone "
                  f"(ctypes, two kernels) {row['launch_host_ms']:.4f}")
        cases.append(row)

    dets = {}
    nms_kernel.nms_sorted.launches = 0
    dets["kernel"] = detection.detect(model, images)
    launches = nms_kernel.nms_sorted.launches
    dets["older"] = with_older_nms(older_nms, lambda: detection.detect(model, images))()
    model.set_nms("plain")
    dets["plain"] = detection.detect(model, images)
    model.set_nms(None)
    checks = {f"detections equal the {route} route's": all(torch.equal(a[k], b[k]) for a, b in zip(dets["kernel"], dets[route])
                                                           for k in a) for route in ("older", "plain")}
    checks["3 nms_sorted launches a forward"] = launches == 3
    faults += [f"detect: {k}" for k, v in checks.items() if not v]
    row = timed_pair("fasterrcnn_resnet50_fpn f32 b8 detect", lambda: detection.detect(model, images),
                     with_older_nms(older_nms, lambda: detection.detect(model, images)), rounds, calls=5)
    row.update(checks=checks, nms_launches=launches, valid=[int(d["valid"].sum()) for d in dets["kernel"]])
    print(f"  {checks}")
    cases.append(row)
    return cases


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-tree", required=True, help="root of an older checkout, under build/")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--json", default=str(REPO / "build" / "blur_nms_ab.json"))
    ap.add_argument("--cases", default="blur_sobel,blur,nms", help="comma-separated groups of cases to run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_blur_nms_ab: no CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    older_stencil, older_nms = load_older(Path(args.old_tree).resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    faults = []
    groups = {"blur_sobel": lambda: blur_sobel_cases(older_stencil, args.rounds, faults),
              "blur": lambda: blur_cases(older_stencil, args.rounds, faults),
              "nms": lambda: nms_cases(older_nms, args.rounds, faults)}
    cases = [case for name in args.cases.split(",") for case in groups[name]()]
    summary = {"card": card, "cases": cases, "failures": faults}
    json_path = Path(args.json)
    json_path.parent.mkdir(parents=True, exist_ok=True)
    json_path.write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    if faults:
        print(f"FAILED: {faults}", file=sys.stderr)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
