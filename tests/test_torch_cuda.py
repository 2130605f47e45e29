"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU. On a machine with
one (the tests' conftest imports JAX, which that machine need not have):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` holds the same kernels against the same plain versions at
the main path's shapes.
"""

import pytest

torch = pytest.importorskip("torch")

from maskrcnn_tpu_torch import config as cfg_lib  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.kernels.region_scatter_cuda import (  # noqa: E402
    region_scatter,
    region_scatter_plain,
)
from maskrcnn_tpu_torch.kernels.roi_align_cuda import (  # noqa: E402
    roi_align_fwd,
    roi_align_region_banded,
    roi_align_region_plain,
)
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import make_train_step  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _banded(shape, g, dev):
    """Weights shaped like ROIAlign's: per row one to four neighbouring
    nonzeros at a random place, every seventh row empty."""
    r, o, t = shape
    w = torch.rand(shape, device=dev, generator=g)
    idx = torch.arange(t, device=dev)
    lo = torch.randint(0, t, (r, o, 1), device=dev, generator=g)
    width = torch.randint(1, 5, (r, o, 1), device=dev, generator=g)
    keep = (idx >= lo) & (idx < lo + width)
    keep &= (torch.arange(r * o, device=dev).reshape(r, o, 1) % 7) != 3
    return w * keep


def _case(dev, s, c, r, oh, ow, ty, tx, seed=0, weights="dense", lo=-3):
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(s, c, device=dev, generator=g)
    base = torch.randint(lo, s, (r,), device=dev, generator=g, dtype=torch.int32)
    stride = torch.randint(0, 64, (r,), device=dev, generator=g, dtype=torch.int32)
    if weights == "dense":
        by = torch.rand(r, oh, ty, device=dev, generator=g)
        bx = torch.rand(r, ow, tx, device=dev, generator=g)
    else:
        by, bx = _banded((r, oh, ty), g, dev), _banded((r, ow, tx), g, dev)
    return flat, base, stride, by, bx


@pytest.mark.parametrize("r,oh,ow,ty,tx,c,lo", [
    (300, 7, 7, 20, 32, 64, -3), (100, 14, 14, 24, 24, 64, -3),
    (5, 1, 3, 1, 5, 64, -3), (3, 16, 9, 7, 33, 64, -3),
    (1, 8, 8, 20, 32, 64, -3), (1, 7, 7, 20, 32, 32, -3),
    (40, 14, 14, 20, 20, 32, -3), (64, 7, 7, 20, 32, 256, -700),
    (64, 14, 14, 24, 24, 256, -700)])
@pytest.mark.parametrize("weights", ["dense", "banded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_fwd_matches_plain(cuda, r, oh, ow, ty, tx, c, lo, weights, dtype):
    """Dense random weights (every band the whole row) and ROIAlign-like
    banded ones with empty rows; windows that start before row 0 (``lo``:
    whole windows in front of the buffer at -700) and run past its end;
    one ROI; one channel tile; window widths that are no multiple of 4 or 8."""
    flat, base, stride, by, bx = _case(cuda, 4000, c, r, oh, ow, ty, tx,
                                       weights=weights, lo=lo)
    flat = flat.to(dtype)
    before = roi_align_fwd.launches
    got = roi_align_fwd(flat, base, stride, by, bx)
    assert roi_align_fwd.launches == before + 1
    want = roi_align_region_plain(flat, base, stride, by, bx)
    torch.cuda.synchronize()
    assert got.shape == (r, oh, ow, c) and got.dtype == torch.float32
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) / scale <= 1e-5
    if r <= 64:  # the kernel's arithmetic step by step
        steps = roi_align_region_banded(flat, base, stride, by, bx)
        assert float((got - steps).abs().max()) / scale <= 1e-5


def test_roi_align_fwd_reads_zero_past_the_end(cuda):
    flat = torch.arange(8 * 32, dtype=torch.float32, device=cuda).reshape(8, 32) + 1
    geo = torch.tensor([6], dtype=torch.int32, device=cuda)
    stride = torch.tensor([2], dtype=torch.int32, device=cuda)
    ones = torch.ones(1, 1, 2, device=cuda)
    out = roi_align_fwd(flat, geo, stride, ones, ones)
    torch.testing.assert_close(out[0, 0, 0], flat[6] + flat[7], rtol=0, atol=0)
    # and before the start: window rows -1, 0 and 1, 2 with base -1
    geo = torch.tensor([-1], dtype=torch.int32, device=cuda)
    out = roi_align_fwd(flat, geo, stride, ones, ones)
    torch.testing.assert_close(out[0, 0, 0], flat[0] + flat[1] + flat[2],
                               rtol=0, atol=0)


def test_roi_align_fwd_skips_a_non_finite_feature_under_a_zero_weight(cuda):
    """The one place where the kernel and its plain version differ on
    purpose: the plain version computes 0 · inf = NaN, the kernel skips the
    term (``roi_align_region_banded`` does the same)."""
    flat = torch.ones(12, 32, device=cuda)
    flat[5] = float("inf")
    by = torch.tensor([[[1.0, 0.0, 0.0]]], device=cuda)
    bx = torch.tensor([[[0.5, 0.5, 0.0]]], device=cuda)
    base = torch.tensor([0], dtype=torch.int32, device=cuda)
    stride = torch.tensor([3], dtype=torch.int32, device=cuda)
    out = roi_align_fwd(flat, base, stride, by, bx)
    assert out.flatten().tolist() == [1.0] * 32
    assert bool(torch.isnan(roi_align_region_plain(flat, base, stride, by, bx)).all())


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
    with pytest.raises(ValueError, match="16-byte aligned"):
        shifted = torch.zeros(100 * 64 + 1, device=cuda)[1:].view(100, 64)
        roi_align_fwd(shifted, base, stride, by, bx)
    empty = roi_align_fwd(flat, base[:0], stride[:0], by[:0], bx[:0])
    assert empty.shape == (0, 7, 7, 64)


def _scatter_case(dev, s_rows, c, r, t, tx, seed=0, overlap=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    d_regs = torch.randn(r, t, tx, c, device=dev, generator=g)
    d_regs[:, :, tx // 2:] = 0  # zero float4s, as outside a ROI's extent
    hi = 64 if overlap else s_rows  # overlap: every window on the same rows
    base = torch.randint(-40, hi, (r,), device=dev, generator=g, dtype=torch.int32)
    stride = torch.randint(0, 300, (r,), device=dev, generator=g, dtype=torch.int32)
    return d_regs, base, stride


@pytest.mark.parametrize("r,t,tx,c,overlap", [
    (512, 20, 32, 256, False), (300, 20, 32, 256, True), (7, 3, 5, 8, False),
    (64, 20, 20, 64, True), (1, 1, 1, 4, False)])
def test_region_scatter_matches_plain(cuda, r, t, tx, c, overlap):
    """Windows past both ends of the buffer (dropped) and, with ``overlap``,
    hundreds of windows on the same rows. The atomics add in an order that
    varies from run to run: 1e-5 of max|plain| bounds float32 rounding of
    sums of up to a few hundred terms."""
    s_rows = 3000
    d_regs, base, stride = _scatter_case(cuda, s_rows, c, r, t, tx, overlap=overlap)
    before = region_scatter.launches
    got = region_scatter(d_regs, base, stride, s_rows)
    assert region_scatter.launches == before + 1
    want = region_scatter_plain(d_regs, base, stride, s_rows)
    torch.cuda.synchronize()
    assert got.shape == (s_rows, c) and got.dtype == torch.float32
    assert got.is_contiguous()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert bool((base + (t - 1) * stride + tx > s_rows).any()) or r < 8


def test_region_scatter_drops_rows_outside_the_buffer(cuda):
    d_regs = torch.ones(1, 2, 4, 8, device=cuda)
    geo = dict(dtype=torch.int32, device=cuda)
    got = region_scatter(d_regs, torch.tensor([-2], **geo),
                         torch.tensor([3], **geo), 4)
    assert got[:, 0].tolist() == [1.0, 2.0, 1.0, 1.0]
    got = region_scatter(d_regs, torch.tensor([3], **geo),
                         torch.tensor([100], **geo), 4)
    assert got[:, 0].tolist() == [0.0, 0.0, 0.0, 1.0]


def test_region_scatter_rejects_what_it_cannot_take(cuda):
    d_regs, base, stride = _scatter_case(cuda, 100, 8, 4, 3, 5)
    with pytest.raises(ValueError, match="multiple of 4"):
        region_scatter(d_regs[..., :6].contiguous(), base, stride, 100)
    with pytest.raises(ValueError, match="contiguous"):
        region_scatter(d_regs.transpose(1, 2), base, stride, 100)
    with pytest.raises(ValueError, match="int32"):
        region_scatter(d_regs, base.long(), stride, 100)
    with pytest.raises(ValueError, match="float32"):
        region_scatter(d_regs.bfloat16(), base, stride, 100)
    empty = region_scatter(d_regs[:0], base[:0], stride[:0], 100)
    assert empty.shape == (100, 8) and float(empty.abs().max()) == 0.0


def test_train_step_launches_the_kernels(cuda):
    """One small train step on the card: the shared pool launches the
    forward kernel twice and the region scatter once, and the step's losses
    agree with the same step on the CPU (plain versions)."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_lib._rep(
        cfg_lib.fpn_mask(), model=dict(n_fg_class=3),
        proposals=dict(n_train_pre_nms=256, n_train_post_nms=64),
        sampler=dict(n_sample=32),
        train=dict(batch_size=2, image_size=(128, 128)))
    batch = SyntheticDetectionData(cfg).batch(0)
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(1)
    draws = (torch.rand((2, 2, 64 + cfg.train.max_gt), generator=gen),
             torch.rand((2, 2, 4092), generator=gen))
    metrics = {}
    for device in ("cuda", "cpu"):
        state = create_train_state(cfg, MaskRCNN(cfg, device=device, seed=0))
        before = roi_align_fwd.launches, region_scatter.launches
        metrics[device] = {k: float(v) for k, v in step(state, batch, draws).items()}
        after = roi_align_fwd.launches, region_scatter.launches
        assert (after[0] - before[0], after[1] - before[1]) == (
            (2, 1) if device == "cuda" else (0, 0))
    for name, want in metrics["cpu"].items():
        assert metrics["cuda"][name] == pytest.approx(want, rel=1e-3), name
