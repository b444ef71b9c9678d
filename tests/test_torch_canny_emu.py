"""Canny's two kernels (``csrc/stencil.cu``: ``canny_strip_kernel``, rows
streamed through a ``cp.async`` ring on a persistent grid, and
``hysteresis_bits_kernel``, the sweeps on bit-packed masks) run on the CPU
through ``tools/cuda_emu``, against the wrappers' plain twins.

The emulator compiles the source with ``g++`` against stand-in headers, runs
one thread per CUDA thread, defers each ``cp.async`` to its wait and poisons
shared memory with NaN.  ``hysteresis_sweeps`` must equal its twin bit for
bit at 1, 4 and 16 sweeps: on maps smaller than the halo (the reflection
periodic), of one row and of one column, at widths that are and are not
multiples of 4, 16 and 32 (rows of 16-byte chunks with the columns past the
edges mirrored on the masks, and rows of byte loads), on strips at the
image's edges and between them, and on more frames than the grid has warps;
its ``changed`` flag and its last sweep's flag must equal the same flags
computed from the twin.  ``canny_stage1`` must equal its twin bit for bit at
K 1, 2, 5 and 7 (and 9, past the unrolled ring of W-blurred rows, and 17,
where a lane blurs one column), with the
twin's square root taken in float64 and rounded to float32: correctly
rounded, as the kernel's ``sqrtf`` is, which ``torch.sqrt`` on the CPU may
not be in the last bit.  Without ``g++`` the tests skip.
"""

import importlib.util
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cpu_vision_tpu_torch.ops import kernels
from cpu_vision_tpu_torch.ops.kernels import stencil

_EMULATE = Path(__file__).resolve().parents[1] / "tools" / "cuda_emu" / "emulate.py"
STEMS = ("stencil",)


@pytest.fixture(autouse=True)
def _launch_counts_at_zero_after():
    """The emulated kernels count their launches; later tests in this process expect CPU tensors to have launched
    nothing."""
    yield
    kernels.reset_launch_counts()


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The emulator module with the stencil source built into a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the CUDA emulation needs a C++20 compiler")
    spec = importlib.util.spec_from_file_location("cuda_emulate", _EMULATE)
    emulate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emulate)
    build_dir = tmp_path_factory.mktemp("cuda_emu")
    emulate.build(build_dir, STEMS)
    return emulate, build_dir


def _run(emulated, fn, args, kwargs=None, sms=None):
    emulate, build_dir = emulated
    with emulate.kernels_on_cpu(build_dir, STEMS):
        if sms is not None:
            torch.cuda.get_device_properties = lambda device: types.SimpleNamespace(multi_processor_count=sms)
        before = fn.launches
        out = fn(*args, **(kwargs or {}))
        assert fn.launches == before + 1  # the emulated kernel ran, not the twin
    return out


def _class_map(shape, seed):
    maps = torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))
    return stencil.canny_stage1_plain(maps, stencil.gaussian_taps(5, 1.4), 0.05, 0.2)


def _root64(x):
    return torch.sqrt(x.double()).float()


HYST_SHAPES = {
    "under_the_halo": ((1, 5, 7), None),
    "one_row": ((1, 1, 40), None),
    "one_column": ((1, 33, 1), None),
    "width_37": ((2, 20, 37), None),
    "width_100": ((1, 40, 100), None),      # a multiple of 4, not of 16: byte loads
    "width_32": ((1, 12, 32), None),        # the narrowest rows of 16-byte chunks
    "width_48": ((1, 9, 48), None),         # chunks, not a multiple of 32
    "width_64_two_row_tiles": ((1, 70, 64), None),
    "border_strips_1920": ((1, 6, 1920), None),
    "interior_strips_3008": ((1, 7, 3008), None),
    "frames_past_the_grid": ((9, 10, 64), 1),  # one block of 4 warps walks 9 tiles
}


@pytest.mark.parametrize("sweeps", [1, 4, 16])
@pytest.mark.parametrize("case", list(HYST_SHAPES))
def test_hysteresis_sweeps_and_flags(emulated, case, sweeps):
    shape, sms = HYST_SHAPES[case]
    cls = _class_map(shape, sum(shape) + sweeps)
    changed, last = torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    out = _run(emulated, kernels.hysteresis_sweeps, (cls, sweeps), {"changed": changed, "last_changed": last}, sms)
    before = stencil.hysteresis_sweeps_plain(cls, sweeps - 1) if sweeps > 1 else cls
    twin = stencil.hysteresis_sweeps_plain(cls, sweeps)
    assert torch.equal(out, twin)
    assert int(changed) == int(bool((twin != cls).any()))
    assert int(last) == int(bool((twin != before).any()))


def test_last_sweep_flag_proves_the_fixpoint(emulated):
    """On a map whose fixpoint takes a few sweeps, the last sweep's flag is 1 until the pass reaches it and 0 from
    the pass whose sweep before the last already reached it."""
    cls = _class_map((1, 48, 96), 7)
    states = [cls]
    while len(states) < 3 or not torch.equal(states[-1], states[-2]):
        states.append(stencil.hysteresis_sweeps_plain(states[-1], 1))
    needed = len(states) - 2  # sweeps that change something
    assert needed >= 2
    for sweeps in (needed, needed + 1):
        last = torch.zeros(1, dtype=torch.int32)
        out = _run(emulated, kernels.hysteresis_sweeps, (cls, sweeps), {"last_changed": last})
        assert torch.equal(out, states[-1]) and int(last) == int(sweeps == needed)


CANNY_CASES = {
    "under_the_halo": ((1, 3, 2), 5),
    "one_row": ((1, 1, 9), 5),
    "one_column": ((2, 7, 1), 3),
    "interior_strips": ((1, 70, 392), 5),
    "unaligned_rows_k7": ((1, 66, 137), 7),
    "even_window": ((1, 20, 260), 2),
    "window_1": ((3, 5, 5), 1),
    "shifting_ring_k9": ((1, 30, 150), 9),
    "one_column_a_lane_k17": ((1, 25, 80), 17),
    "persistent": ((40, 6, 10), 5),
}


@pytest.mark.parametrize("case", list(CANNY_CASES))
def test_canny_stage1(emulated, case):
    shape, ks = CANNY_CASES[case]
    maps = torch.from_numpy(np.random.default_rng(sum(shape) + ks).random(shape, dtype=np.float32))
    out = _run(emulated, kernels.canny_stage1, (maps, 0.05, 0.15, ks, 1.3), sms=2 if case == "persistent" else None)
    twin = stencil.canny_stage1_plain(maps, stencil.gaussian_taps(ks, 1.3), 0.05, 0.15, root=_root64)
    assert torch.equal(out, twin)
    assert bool((out == 2).any()) or shape[1] * shape[2] < 50  # the thresholds leave strong pixels to compare
