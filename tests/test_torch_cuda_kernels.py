"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked `cuda`: they skip where there is no GPU. The file imports no JAX, so
it also runs on a machine without it:
    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_kernels.py
Tolerances: fp32 within 1e-4 (summation order); bf16 within 0.0625 +
0.03*|plain| (a few bf16 ulps: both round at the same points, but a value
on a rounding boundary can land one ulp apart and carry on).
"""

import pytest
import torch

from gluefactory_tpu_torch.ops import lightglue_block as lb
from gluefactory_tpu_torch.ops import log_assignment as la

pytestmark = pytest.mark.cuda
D = 256


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rn(gen, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


def _weights(gen, dtype, cross):
    w = lambda din, dout: _rn(gen, din, dout, scale=din**-0.5, dtype=dtype)
    b = lambda k: _rn(gen, k, scale=0.1, dtype=dtype)
    pre = [w(D, D), b(D), w(D, D), b(D)] if cross else [w(D, 3 * D), b(3 * D)]
    ln = (1 + _rn(gen, 2 * D, scale=0.1)).to(dtype)
    return pre + [w(D, D), b(D), w(2 * D, 2 * D), b(2 * D), ln, b(2 * D), w(2 * D, D), b(D)]


def _close(out, ref, dtype):
    atol, rtol = (1e-4, 1e-5) if dtype == torch.float32 else (0.0625, 0.03)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_blocks_match_plain(gen, dtype, masked):
    s, n = 4, 200
    x = _rn(gen, s, n, D, dtype=dtype)
    angles = torch.rand(s, n, 32, generator=gen, device="cuda") * 6
    cos = torch.cos(angles).repeat_interleave(2, -1).to(dtype).contiguous()
    sin = torch.sin(angles).repeat_interleave(2, -1).to(dtype).contiguous()
    mask = torch.rand(s, n, generator=gen, device="cuda") > 0.3
    mask[1] = False
    w = _weights(gen, dtype, cross=False)
    before = lb.fused_self_block.launches
    out = lb.fused_self_block(x, cos, sin, mask, *w, masked=masked)
    assert lb.fused_self_block.launches == before + 1
    _close(out, lb.self_block(x, cos, sin, mask, *w, masked=masked), dtype)
    w = _weights(gen, dtype, cross=True)
    out = lb.fused_cross_block(x, mask, *w, masked=masked)
    _close(out, lb.cross_block(x, mask, *w, masked=masked), dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_log_assignment_matches_plain(gen, masked):
    b, m, n = 2, 150, 170
    d0, d1 = _rn(gen, b, m, D, scale=D**-0.25), _rn(gen, b, n, D, scale=D**-0.25)
    z0, z1 = _rn(gen, b, m), _rn(gen, b, n)
    masks = (torch.rand(b, m, generator=gen, device="cuda") > 0.25,
             torch.rand(b, n, generator=gen, device="cuda") > 0.25) if masked else (None, None)
    out = la.fused_log_assignment(d0, d1, z0, z1, *masks)
    ref = la.log_assignment(d0, d1, z0, z1, *masks)
    for o, r in zip(out, ref):
        if o.dtype == torch.int32:
            assert (o == r).float().mean() > 0.99
        else:
            torch.testing.assert_close(o, r, atol=1e-4, rtol=1e-5)


def test_wrappers_check_their_inputs(gen):
    x = _rn(gen, 2, 64, D, dtype=torch.float16)
    w = _weights(gen, torch.float16, cross=True)
    with pytest.raises(TypeError):
        lb.fused_cross_block(x, None, *w, masked=False)
