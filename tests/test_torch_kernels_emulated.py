"""The port's CUDA kernel sources, run on the CPU through a host-compiler
emulation of the CUDA subset they use (tests/cuda_emu), against the plain
PyTorch versions.

This holds the kernels' indexing, tiling, masking and reductions without a
GPU; what it cannot hold is anything the GPU compiler or hardware decides
(that is chip_smoke.py's job). Small ragged shapes (N not a multiple of the
64-row tiles) exercise the edges. Tolerances: fp32 within 2e-5 (summation
order); bf16 within one bf16 ulp at the outputs' magnitude (atol 0.0625 +
rtol 0.02).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from gluefactory_tpu_torch import _ext
from gluefactory_tpu_torch.ops import lightglue_block as lb
from gluefactory_tpu_torch.ops import log_assignment as la

ROOT = Path(__file__).resolve().parent.parent
EMU = Path(__file__).resolve().parent / "cuda_emu"
D = 256


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_emu")
    procs = {}
    for name in _ext.SIGNATURES:
        target = out / f"lib{name}.so"
        cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-include", "cuda_runtime.h",
               f"-I{EMU}", "-x", "c++", str(ROOT / "gluefactory_tpu_torch" / "csrc" / f"{name}.cu"),
               "-o", str(target), "-lpthread"]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), target)
    loaded = {}
    for name, (proc, target) in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        lib = ctypes.CDLL(str(target))
        for fn, argtypes in _ext.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        loaded[name] = lib
    return loaded


def _weights(gen, dtype, cross):
    rn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dtype)
    w = lambda din, dout: rn(din, dout, scale=din**-0.5)
    b = lambda k: rn(k, scale=0.1)
    pre = [w(D, D), b(D), w(D, D), b(D)] if cross else [w(D, 3 * D), b(3 * D)]
    ln = (1 + torch.randn(2 * D, generator=gen) * 0.1).to(dtype)
    return pre + [w(D, D), b(D), w(2 * D, 2 * D), b(2 * D), ln, b(2 * D), w(2 * D, D), b(D)]


def _close(out, ref, dtype):
    atol, rtol = (2e-5, 1e-5) if dtype == torch.float32 else (0.0625, 0.02)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype,masked", [(torch.float32, True), (torch.bfloat16, True),
                                          (torch.bfloat16, False)])
def test_block_kernels_match_plain(libs, dtype, masked):
    gen = torch.Generator().manual_seed(int(masked) + 2 * (dtype == torch.bfloat16))
    s, n = 2, 72
    x = torch.randn(s, n, D, generator=gen).to(dtype)
    angles = torch.rand(s, n, 32, generator=gen) * 6
    cos = torch.cos(angles).repeat_interleave(2, -1).to(dtype).contiguous()
    sin = torch.sin(angles).repeat_interleave(2, -1).to(dtype).contiguous()
    mask = torch.rand(s, n, generator=gen) > 0.3
    mask[1] = False  # a set with no valid token
    kmask = mask if masked else None
    lib = libs["lightglue_block"]

    w = _weights(gen, dtype, cross=False)
    out = lb.launch_self_block(lib, None, x, cos, sin, kmask, *w, 4)
    _close(out, lb.self_block(x, cos, sin, mask, *w, masked=masked), dtype)

    w = _weights(gen, dtype, cross=True)
    out = lb.launch_cross_block(lib, None, x, kmask, *w, 4)
    _close(out, lb.cross_block(x, mask, *w, masked=masked), dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_log_assignment_kernels_match_plain(libs, masked):
    gen = torch.Generator().manual_seed(7 + masked)
    b, m, n, d = 2, 70, 90, 64
    d0 = torch.randn(b, m, d, generator=gen) / d**0.25
    d1 = torch.randn(b, n, d, generator=gen) / d**0.25
    z0, z1 = torch.randn(b, m, generator=gen), torch.randn(b, n, generator=gen)
    masks = (torch.rand(b, m, generator=gen) > 0.25,
             torch.rand(b, n, generator=gen) > 0.25) if masked else (None, None)
    out = la.launch_log_assignment(libs["log_assignment"], None, d0, d1, z0, z1, *masks)
    ref = la.log_assignment(d0, d1, z0, z1, *masks)
    for o, r in zip(out, ref):
        if o.dtype == torch.int32:
            torch.testing.assert_close(o, r, atol=0, rtol=0)
        else:
            torch.testing.assert_close(o, r, atol=2e-5, rtol=1e-5)
