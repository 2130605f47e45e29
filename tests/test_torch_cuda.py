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
from maskrcnn_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticDetectionData,
    SyntheticRequests,
)
from maskrcnn_tpu_torch.eval.predict import make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.kernels.region_scatter_cuda import (  # noqa: E402
    region_scatter,
    region_scatter_exact,
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


F32, BF16 = torch.float32, torch.bfloat16
SCATTER_PAIRS = [(F32, F32), (BF16, F32), (BF16, BF16), (F32, BF16)]


@pytest.mark.parametrize("dtype,acc", SCATTER_PAIRS)
@pytest.mark.parametrize("r,t,tx,c,overlap", [
    (512, 20, 32, 256, False), (300, 20, 32, 256, True), (7, 3, 5, 8, False),
    (64, 20, 20, 64, True), (1, 1, 1, 4, False)])
def test_region_scatter_matches_plain(cuda, r, t, tx, c, overlap, dtype, acc):
    """Windows past both ends of the buffer (dropped) and, with ``overlap``,
    hundreds of windows on the same rows, in every (input, accumulator)
    dtype pair; the result has the input's dtype. C = 4 is one float4 per
    window column in the float32 kernel; the other pairs move 16-byte
    vectors of 8 and take C = 8 there.

    The atomics add in an order that varies from run to run. Kernel and
    plain version must both lie, element by element, within
    ``region_scatter_exact``'s rounding bound of the float64 sum; with a
    bf16 accumulator, whose bound grows with the square of the windows that
    meet, the kernel's mean error must also stay within twice the plain
    version's (the same rounded adds in another order). In float32 the
    kernel also stays within 1e-5 of max|plain|."""
    if (dtype, acc) != (F32, F32):
        c = max(c, 8)
    s_rows = 3000
    d_regs, base, stride = _scatter_case(cuda, s_rows, c, r, t, tx, overlap=overlap)
    d_regs = d_regs.to(dtype)
    before = region_scatter.launches
    got = region_scatter(d_regs, base, stride, s_rows, acc)
    assert region_scatter.launches == before + 1
    want = region_scatter_plain(d_regs, base, stride, s_rows, acc)
    torch.cuda.synchronize()
    assert got.shape == (s_rows, c) and got.dtype == dtype
    assert got.is_contiguous()
    exact, bound = region_scatter_exact(d_regs, base, stride, s_rows, acc)
    err, plain_err = (got.double() - exact).abs(), (want.double() - exact).abs()
    assert bool((plain_err <= bound).all())
    assert bool((err <= bound).all()), float((err - bound).max())
    if acc == BF16:
        assert float(err.mean()) <= 2 * float(plain_err.mean())
    if dtype == acc == F32:
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert bool((base + (t - 1) * stride + tx > s_rows).any()) or r < 8


@pytest.mark.parametrize("dtype,acc", SCATTER_PAIRS)
def test_region_scatter_sums_exactly_what_every_dtype_holds(cuda, dtype, acc):
    """Small integers add exactly in every dtype, whatever the order: the
    kernel and its plain version agree bit for bit, and so do a window that
    rounds into bf16 and its float32 sum."""
    s_rows, r, t, tx, c = 2000, 12, 20, 32, 256
    d_regs, base, stride = _scatter_case(cuda, s_rows, c, r, t, tx, overlap=True)
    d_regs = d_regs.round().clamp(-1, 1).to(dtype)  # |partial sums| ≤ 12·20
    got = region_scatter(d_regs, base, stride, s_rows, acc)
    want = region_scatter_plain(d_regs, base, stride, s_rows, acc)
    exact = region_scatter_plain(d_regs.double(), base, stride, s_rows, torch.float64)
    assert float(exact.abs().max()) <= 256
    assert torch.equal(got, want)
    assert torch.equal(got.double(), exact)


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
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        region_scatter(d_regs.half(), base, stride, 100)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        region_scatter(d_regs, base, stride, 100, torch.float16)
    with pytest.raises(ValueError, match="multiple of 8"):  # 16-byte bf16 vectors
        region_scatter(d_regs[..., :4].contiguous().bfloat16(), base, stride, 100)
    empty = region_scatter(d_regs[:0], base[:0], stride[:0], 100)
    assert empty.shape == (100, 8) and float(empty.abs().max()) == 0.0
    empty = region_scatter(d_regs[:0].bfloat16(), base[:0], stride[:0], 100)
    assert empty.dtype == torch.bfloat16 and float(empty.abs().max()) == 0.0


def _bf16_cfg(**model):
    return cfg_lib._rep(
        cfg_lib.fpn_mask(), model=dict(n_fg_class=3, dtype="bfloat16", **model),
        proposals=dict(n_train_pre_nms=256, n_train_post_nms=64,
                       n_test_pre_nms=256, n_test_post_nms=32),
        sampler=dict(n_sample=32), eval=dict(max_detections=16),
        train=dict(batch_size=2, image_size=(256, 320),
                   momentum_dtype="bfloat16"))


def test_bf16_predict_runs_through_the_kernel(cuda):
    """bf16 two-pass predict on the card: both pools read bf16 features
    (2 launches), detections come out float32 and finite."""
    cfg = _bf16_cfg()
    model = MaskRCNN(cfg, device="cuda", seed=0)
    req = SyntheticRequests(cfg).batch(0)
    before = roi_align_fwd.launches
    det = make_predict_fn(cfg, model)(req.images, req.img_hw, req.scale)
    torch.cuda.synchronize()
    assert roi_align_fwd.launches == before + 2
    assert det.boxes.dtype == det.scores.dtype == det.masks.dtype == torch.float32
    for x in (det.boxes, det.scores, det.masks):
        assert bool(torch.isfinite(x).all())


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_bf16_trainable_bn_step_runs_through_the_kernels(cuda, acc):
    """bf16 train steps with trainable BN, a bf16 momentum buffer and both
    accumulators: 2 forward launches and 1 region scatter a step, finite
    losses, every parameter and every running statistic moved."""
    cfg = _bf16_cfg(freeze_bn=False, roi_align_acc=acc)
    state = create_train_state(cfg, MaskRCNN(cfg, device="cuda", seed=0))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_train_step(cfg)
    launches = roi_align_fwd.launches, region_scatter.launches
    for i in range(2):
        m = step(state, SyntheticDetectionData(cfg).batch(i))
        assert all(bool(torch.isfinite(v)) for v in m.values())
        assert m["loss"].dtype == torch.float32
    assert (roi_align_fwd.launches - launches[0],
            region_scatter.launches - launches[1]) == (4, 2)
    after = state.model.state_dict()
    still = [k for k in after if torch.equal(after[k], before[k])]
    assert still == []
    buf = state.optimizer.state[state.model.head.box.score.weight]["momentum_buffer"]
    assert buf.dtype == torch.bfloat16


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
