"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU. On a machine with
one (the tests' conftest imports JAX, which that machine need not have):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` holds the same kernels against the same plain versions at
the main path's shapes.
"""

import pytest

torch = pytest.importorskip("torch")

from maskrcnn_tpu_torch.kernels.roi_align_cuda import (  # noqa: E402
    roi_align_fwd,
    roi_align_region_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, s, c, r, oh, ow, ty, tx, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(s, c, device=dev, generator=g)
    base = torch.randint(-3, s, (r,), device=dev, generator=g, dtype=torch.int32)
    stride = torch.randint(0, 64, (r,), device=dev, generator=g, dtype=torch.int32)
    by = torch.rand(r, oh, ty, device=dev, generator=g)
    bx = torch.rand(r, ow, tx, device=dev, generator=g)
    return flat, base, stride, by, bx


@pytest.mark.parametrize("r,oh,ow,ty,tx", [
    (300, 7, 7, 20, 32), (100, 14, 14, 24, 24), (5, 1, 3, 1, 5),
    (3, 16, 9, 7, 33), (1, 8, 8, 20, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_fwd_matches_plain(cuda, r, oh, ow, ty, tx, dtype):
    flat, base, stride, by, bx = _case(cuda, 4000, 64, r, oh, ow, ty, tx)
    flat = flat.to(dtype)
    before = roi_align_fwd.launches
    got = roi_align_fwd(flat, base, stride, by, bx)
    assert roi_align_fwd.launches == before + 1
    want = roi_align_region_plain(flat, base, stride, by, bx)
    torch.cuda.synchronize()
    assert got.shape == (r, oh, ow, 64) and got.dtype == torch.float32
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-5


def test_roi_align_fwd_reads_zero_past_the_end(cuda):
    flat = torch.arange(8 * 32, dtype=torch.float32, device=cuda).reshape(8, 32) + 1
    geo = torch.tensor([6], dtype=torch.int32, device=cuda)
    stride = torch.tensor([2], dtype=torch.int32, device=cuda)
    ones = torch.ones(1, 1, 2, device=cuda)
    out = roi_align_fwd(flat, geo, stride, ones, ones)
    torch.testing.assert_close(out[0, 0, 0], flat[6] + flat[7], rtol=0, atol=0)


def test_roi_align_fwd_rejects_what_it_cannot_take(cuda):
    flat, base, stride, by, bx = _case(cuda, 100, 64, 4, 7, 7, 20, 32)
    with pytest.raises(ValueError, match="multiple of 32"):
        roi_align_fwd(flat[:, :48].contiguous(), base, stride, by, bx)
    with pytest.raises(ValueError, match="contiguous"):
        roi_align_fwd(flat, base, stride, by.transpose(1, 2).contiguous()
                      .transpose(1, 2), bx)
    with pytest.raises(ValueError, match="int32"):
        roi_align_fwd(flat, base.long(), stride, by, bx)
    with pytest.raises(ValueError, match="output sizes"):
        big = torch.rand(4, 17, 20, device=cuda)
        roi_align_fwd(flat, base, stride, big, bx)
    empty = roi_align_fwd(flat, base[:0], stride[:0], by[:0], bx[:0])
    assert empty.shape == (0, 7, 7, 64)
