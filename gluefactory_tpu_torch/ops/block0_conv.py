"""SuperPoint's block 0 as one kernel: the plain PyTorch version and the
wrapper of the CUDA kernel in csrc/block0_conv.cu.

Counterpart of `block0_fused` in gluefactory_tpu/ops/pallas_conv.py (:172):
conv 3x3 1->64 + bias, ReLU, folded BatchNorm; conv 3x3 64->64 + bias,
ReLU, folded BatchNorm; 2x2 max pool. The arguments are that function's:
the image (B, H, W, 1) fp32 in [0, 1], the plain conv kernels in HWIO
layout ((3, 3, 1, 64) and (3, 3, 64, 64)), the conv biases and the folded
inference BatchNorm (`mul = scale * rsqrt(var + eps)`, `add = bias - mean *
mul`), each (64,). The result is (B, H/2, W/2, 64) bf16, channels last. H
and W must be even; nothing else is asked of them.

Rounding points, shared by the plain version and the kernel: image and
weights are rounded to bf16; conv1a accumulates in fp32, is cast to bf16 and
its bias / ReLU / BN affine run in bf16; conv1b (zero padding of conv1a's
output) accumulates in fp32, and its bias / ReLU / BN affine and the max run
in fp32; the output is cast to bf16 once.

`block0_fused` runs the plain version for a CPU image and launches the
kernel for a CUDA image; it counts its launches in `.launches`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _ext

_C = 64


def _oihw(w_hwio):
    return w_hwio.permute(3, 2, 0, 1)


def block0_plain(image, w1, b1, mul1, add1, w2, b2, mul2, add2):
    """The plain version: two `conv2d` calls with the kernel's rounding
    points. Returns (B, H/2, W/2, 64) bf16."""
    bf = torch.bfloat16
    r = lambda t: t.to(bf).float()  # a value rounded to bf16, held in fp32
    c = lambda t: t.to(bf)[None, :, None, None]
    x = r(image).permute(0, 3, 1, 2)
    y = F.conv2d(x, r(_oihw(w1)), padding=1).to(bf)
    y = F.relu(y + c(b1)) * c(mul1) + c(add1)  # bf16 arithmetic, every op rounds
    f = lambda t: t.float()[None, :, None, None]
    z = F.conv2d(y.float(), r(_oihw(w2)), padding=1)
    z = F.relu(z + f(b2)) * f(mul2) + f(add2)
    return F.max_pool2d(z, 2, 2).to(bf).permute(0, 2, 3, 1).contiguous()


def _ptr(t):
    return t.data_ptr()


def launch_block0(lib, stream, image, w1, b1, mul1, add1, w2, b2, mul2, add2, *, blocks):
    """Run the kernel through `lib`: image (B, H, W, 1) fp32 contiguous, the
    weights fp32 contiguous in HWIO layout; `blocks` thread blocks, each of
    which walks over tiles (one a multiprocessor fills the card). Returns
    (B, H/2, W/2, 64) bf16."""
    b, h, w, _ = image.shape
    out = torch.empty((b, h // 2, w // 2, _C), dtype=torch.bfloat16, device=image.device)
    _ext.check(lib.b0_block0(
        _ptr(image), _ptr(w1), _ptr(b1), _ptr(mul1), _ptr(add1), _ptr(w2), _ptr(b2),
        _ptr(mul2), _ptr(add2), _ptr(out), b, h, w, blocks, stream), "b0_block0")
    return out


def _check(image, w1, w2, vectors):
    if image.ndim != 4 or image.shape[-1] != 1:
        raise ValueError(f"block0_fused: the image must be (B, H, W, 1), got {tuple(image.shape)}")
    if image.shape[1] % 2 or image.shape[2] % 2:
        raise ValueError("block0_fused: H and W must be even (a 2x2 pool follows)")
    if tuple(w1.shape) != (3, 3, 1, _C) or tuple(w2.shape) != (3, 3, _C, _C):
        raise ValueError("block0_fused: the conv kernels must be (3, 3, 1, 64) and "
                         "(3, 3, 64, 64), HWIO")
    for t in vectors:
        if tuple(t.shape) != (_C,):
            raise ValueError("block0_fused: biases and the folded BatchNorm must be (64,)")
    for t in (w1, w2, *vectors):
        if t.device != image.device:
            raise ValueError(f"block0_fused: all tensors must be on {image.device}")


def block0_fused(image, w1, b1, mul1, add1, w2, b2, mul2, add2):
    """`block0_plain` on the CPU; the CUDA kernel on the card."""
    vectors = (b1, mul1, add1, b2, mul2, add2)
    _check(image, w1, w2, vectors)
    if image.device.type == "cpu":
        return block0_plain(image, w1, b1, mul1, add1, w2, b2, mul2, add2)
    f = lambda t: t.detach().float().contiguous()
    lib = _ext.load("block0_conv")
    out = launch_block0(lib, torch.cuda.current_stream(image.device).cuda_stream, f(image),
                        f(w1), f(b1), f(mul1), f(add1), f(w2), f(b2), f(mul2), f(add2),
                        blocks=torch.cuda.get_device_properties(image.device).multi_processor_count)
    block0_fused.launches += 1
    return out


block0_fused.launches = 0

__all__ = ["block0_plain", "launch_block0", "block0_fused"]
