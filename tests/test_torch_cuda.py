"""The hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU. On a machine with
one (the tests' conftest imports JAX, which that machine need not have):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` holds the same kernels against the same plain versions at
the main path's shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from maskrcnn_tpu_torch import config as cfg_lib  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticDetectionData,
    SyntheticRequests,
)
from maskrcnn_tpu_torch.eval.predict import make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.kernels import nms_cuda  # noqa: E402
from maskrcnn_tpu_torch.kernels.region_scatter_cuda import (  # noqa: E402
    region_scatter,
    region_scatter_exact,
    region_scatter_ordered,
    region_scatter_plain,
    segment_starts,
)
from maskrcnn_tpu_torch.kernels.roi_align_cuda import (  # noqa: E402
    roi_align_fwd,
    roi_align_region_banded,
    roi_align_region_plain,
)
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.ops.nms import nms_padded  # noqa: E402
from maskrcnn_tpu_torch.train import step as step_mod  # noqa: E402
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

    The kernel adds in the order of its sorted window rows, the plain
    version in ROI order. Kernel and plain version must both lie, element
    by element, within
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


def _p6_case(dev, r, c, seed=0):
    """Every ROI on the coarsest level of one image, as the train step's
    large boxes: the last 208 rows of an 800×1024 b2 pyramid (P6 of the
    last image), 20×32 windows with strides of 1–7 rows (under tx), windows
    past the buffer's end; hundreds of terms meet on a row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s_rows = 136_416
    level0 = s_rows - 13 * 16  # the last image's P6 rows
    base = level0 + torch.randint(-8, 80, (r,), device=dev, generator=g,
                                  dtype=torch.int32)
    stride = torch.randint(1, 8, (r,), device=dev, generator=g, dtype=torch.int32)
    d_regs = torch.randn(r, 20, 32, c, device=dev, generator=g)
    d_regs[:, :, 20:] = 0
    return d_regs, base, stride, s_rows


@pytest.mark.parametrize("dtype,acc", SCATTER_PAIRS)
@pytest.mark.parametrize("case", ["overlap", "p6", "small"])
def test_region_scatter_equals_ordered_bit_for_bit(cuda, case, dtype, acc):
    """No atomics: each output element's adds run in one fixed order, that of
    ``region_scatter_ordered``, whose adds have no multiply to contract. So
    the kernel equals it bit for bit, and two calls on the same inputs give
    the same bits."""
    if case == "p6":
        d_regs, base, stride, s_rows = _p6_case(cuda, 233, 256)
    elif case == "overlap":
        s_rows = 3000
        d_regs, base, stride = _scatter_case(cuda, s_rows, 64, 300, 20, 32,
                                             overlap=True)
    else:
        s_rows = 50
        d_regs, base, stride = _scatter_case(cuda, s_rows, 8, 7, 3, 5)
    d_regs = d_regs.to(dtype)
    got = region_scatter(d_regs, base, stride, s_rows, acc)
    again = region_scatter(d_regs, base, stride, s_rows, acc)
    want = region_scatter_ordered(d_regs, base, stride, s_rows, acc)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (s_rows, d_regs.shape[-1])
    assert torch.equal(got, again)
    assert torch.equal(got, want), int((got != want).sum())
    exact, bound = region_scatter_exact(d_regs, base, stride, s_rows, acc)
    assert bool(((got.double() - exact).abs() <= bound).all())
    if case == "p6":  # the skew: hundreds of windows on the same rows
        meet = region_scatter_plain(torch.ones_like(d_regs[..., :1]), base,
                                    stride, s_rows)
        assert float(meet.max()) >= 100


@pytest.mark.parametrize("r,t,lo,hi", [
    (512, 20, -40, 3000), (2048, 20, -40, 3000), (233, 20, 2900, 2990),
    (1, 3, -40, 3000), (0, 20, 0, 1), (103, 7, -5000, 5000)])
def test_region_scatter_sorts_segments_like_a_stable_sort(cuda, r, t, lo, hi):
    """The kernel's bookkeeping against ``torch.sort(stable=True)`` of
    ``segment_starts``: one chunk, several (2048 segments a block), a last
    chunk part full, none; ties (ROIs on the same rows, stride 0) and starts
    clamped at both ends."""
    g = torch.Generator(device=cuda).manual_seed(r)
    s_rows, tx = 3000, 32
    base = torch.randint(lo, hi, (r,), device=cuda, generator=g, dtype=torch.int32)
    stride = torch.randint(0, 40, (r,), device=cuda, generator=g, dtype=torch.int32)
    stride[::5] = 0
    got_start, tbase = region_scatter.sorted_segments(base, stride, t, tx, s_rows)
    want_start, order = torch.sort(segment_starts(base, stride, t, tx, s_rows),
                                   stable=True)
    assert torch.equal(got_start, want_start)
    assert torch.equal(tbase, (order * tx - want_start).int())


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


@pytest.mark.parametrize("content", ["probs", "binary_uint8"])
def test_paste_masks_on_the_card_equals_the_cpu(cuda, content):
    """``paste_masks`` (and ``crop_to_full_mask``) is elementwise float32
    arithmetic and gathers: the card gives the CPU's bits, on boxes across
    the canvas edge, under 28 px and of zero extent."""
    from maskrcnn_tpu_torch.eval.evaluator import crop_to_full_mask
    from maskrcnn_tpu_torch.eval.postprocess import paste_masks

    gen = torch.Generator().manual_seed(0)
    d, hw = 64, (800, 1024)
    y0 = torch.rand(d, generator=gen) * 900 - 60
    x0 = torch.rand(d, generator=gen) * 1100 - 60
    size = torch.rand(d, 2, generator=gen) ** 2 * 500
    size[::7] = 0.0
    boxes = torch.stack([y0, x0, y0 + size[:, 0], x0 + size[:, 1]], 1)
    valid = torch.rand(d, generator=gen) < 0.9
    if content == "probs":
        masks = torch.rand(d, 28, 28, generator=gen)
        got = paste_masks(boxes.cuda(), masks.cuda(), valid.cuda(), hw)
        want = paste_masks(boxes, masks, valid, hw)
    else:
        masks = torch.where(torch.rand(d, 112, 112, generator=gen) < 0.5, 255, 0).to(torch.uint8)
        got = crop_to_full_mask(masks.cuda(), boxes.cuda(), valid.cuda(), hw)
        want = crop_to_full_mask(masks, boxes, valid, hw)
    assert got.device.type == "cuda" and got.shape == want.shape == (int(valid.sum()), *hw)
    assert want.any() and torch.equal(got.cpu(), want)


def _capturing(monkeypatch):
    """Route the shared pool's kernel calls through recorders that keep
    copies of their arguments."""
    from maskrcnn_tpu_torch.ops import roi_align as roi_align_ops

    calls = {"fwd": [], "bwd": []}

    def recorder(fn, key):
        def wrapped(*args):
            calls[key].append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                    for a in args))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(roi_align_ops, "roi_align_fwd", recorder(roi_align_fwd, "fwd"))
    monkeypatch.setattr(roi_align_ops, "region_scatter",
                        recorder(region_scatter, "bwd"))
    return calls


@pytest.mark.parametrize("preset,hw", [
    ("fpn_keypoint", (256, 320)), ("fpn_keypoint", (320, 256)),
    ("fpn_mask", (320, 256))])
def test_kernels_match_plain_on_keypoint_and_portrait_paths(cuda, monkeypatch,
                                                            preset, hw):
    """A predict and a train step of the keypoint head (one class, the 14²
    class-agnostic pool, its own positives) and of the portrait bucket's
    pyramid (other row strides): 2 forward launches a request, 2 and 1
    region scatter a step; every call's output equals its plain version
    (ROIAlign within 1e-5 of max |plain|; the region scatter bit for bit
    equal to ``region_scatter_ordered`` and within its exact bound)."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_lib._rep(
        cfg_lib.PRESETS[preset](),
        proposals=dict(n_train_pre_nms=1000, n_train_post_nms=256,
                       n_test_pre_nms=1000, n_test_post_nms=100),
        train=dict(batch_size=2, image_size=hw))
    model = MaskRCNN(cfg, device="cuda", seed=0)
    with torch.no_grad():
        model.head.box.score.weight.mul_(8.0)  # detections to pool
    calls = _capturing(monkeypatch)
    req = SyntheticRequests(cfg).batch(0)
    det = make_predict_fn(cfg, model)(req.images, req.img_hw, req.scale)
    assert len(calls["fwd"]) == 2 and not calls["bwd"] and int(det.valid.sum()) > 0
    if preset == "fpn_keypoint":
        assert det.masks is None and det.heatmaps.shape[2:] == (56, 56, 17)
    step = make_train_step(cfg)
    m = step(create_train_state(cfg, model), SyntheticDetectionData(cfg).batch(0))
    assert all(bool(torch.isfinite(v)) for v in m.values())
    assert len(calls["fwd"]) == 4 and len(calls["bwd"]) == 1
    for args in calls["fwd"]:
        got, want = roi_align_fwd(*args), roi_align_region_plain(*args)
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err <= 1e-5
    args = calls["bwd"][0]
    got = region_scatter(*args)
    assert torch.equal(got, region_scatter_ordered(*args))
    exact, bound = region_scatter_exact(*args)
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert bool(((region_scatter_plain(*args).double() - exact).abs() <= bound).all())


def test_keypoint_predict_on_the_card_matches_the_cpu(cuda):
    """The keypoint head's two-pass predict at 256×320: equal valid and
    labels, boxes, scores and heatmaps within 1e-3 of max(1, max |CPU|)."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfg_lib._rep(cfg_lib.fpn_keypoint(),
                       train=dict(batch_size=1, image_size=(256, 320)))
    req = SyntheticRequests(cfg).batch(0)
    dets = {}
    for device in ("cuda", "cpu"):
        model = MaskRCNN(cfg, device=device, seed=0)
        with torch.no_grad():
            model.head.box.score.weight.mul_(8.0)
        dets[device] = make_predict_fn(cfg, model)(req.images, req.img_hw, req.scale)
    got, want = dets["cuda"], dets["cpu"]
    assert int(want.valid.sum()) > 0
    assert torch.equal(got.valid.cpu(), want.valid)
    assert torch.equal(got.labels.cpu(), want.labels)
    for name in ("boxes", "scores", "heatmaps"):
        g, w = getattr(got, name).cpu(), getattr(want, name)
        assert float((g - w).abs().max()) <= 1e-3 * max(1.0, float(w.abs().max())), name


@pytest.mark.parametrize("c", [490, 1024])
@pytest.mark.parametrize("impl", ["pallas", "region"])
def test_single_pool_trains_through_both_kernels_as_on_the_cpu(cuda, c, impl):
    """The single-pool train path (``_RegionPool``) on one C4 level: the
    pool and the feature gradient on the card (B2 forward, B1 backward,
    at C=490 padded to 512 or at C=1024) against the CPU's plain versions;
    one launch of each kernel."""
    from maskrcnn_tpu_torch.ops.roi_align import multilevel_roi_align

    g = torch.Generator().manual_seed(c)
    feats = torch.randn(2, 20, 24, c, generator=g)
    y0, x0 = torch.rand(40, generator=g) * 240, torch.rand(40, generator=g) * 300
    size = 16 + torch.rand(40, 2, generator=g) * 200
    rois = torch.stack([y0, x0, y0 + size[:, 0], x0 + size[:, 1]], 1)
    bi = torch.randint(0, 2, (40,), generator=g, dtype=torch.int32)
    lv = torch.zeros(40, dtype=torch.int32)
    cot = torch.randn(40, 7, 7, c, generator=g)
    out = {}
    for dev in ("cpu", cuda):
        f = feats.to(dev).detach().requires_grad_()
        roi_align_fwd.launches = region_scatter.launches = 0
        pooled = multilevel_roi_align([f], rois.to(dev), bi.to(dev), lv.to(dev),
                                      (7, 7), (1.0 / 16,), impl=impl)
        (pooled * cot.to(dev)).sum().backward()
        out[str(dev)] = pooled.detach().cpu(), f.grad.cpu()
        launches = (roi_align_fwd.launches, region_scatter.launches)
    assert launches == (1, 1)
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.shape == want.shape
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err <= 1e-5, err


@pytest.mark.parametrize("preset", ["light_head", "c4_res5"])
def test_c4_preset_pallas_step_launches_both_kernels_twice(cuda, preset):
    """One ``roi_align="pallas"`` train step of each C4 preset at 256×320:
    B2 and B1 twice each (the box pool and the mask pool), finite losses."""
    cfg = cfg_lib._rep(cfg_lib.PRESETS[preset](), model=dict(roi_align="pallas"),
                       train=dict(batch_size=2, image_size=(256, 320)),
                       proposals=dict(n_train_pre_nms=1000, n_train_post_nms=256),
                       sampler=dict(n_sample=64))
    state = create_train_state(cfg, MaskRCNN(cfg, seed=0))
    batch = SyntheticDetectionData(cfg, seed=0).batch(0)
    roi_align_fwd.launches = region_scatter.launches = 0
    m = make_train_step(cfg)(state, batch)
    assert (roi_align_fwd.launches, region_scatter.launches) == (2, 2)
    assert all(bool(torch.isfinite(v)) for v in m.values())


def _darknet_level_case(dev, r, out, seed=0):
    """Pallas-geometry inputs on the Darknet level of a 256x320 image (one
    16x20 level of 256 channels, a 24-cell window at C=256) for ``r``
    proposal-like ROIs over batch 8."""
    from maskrcnn_tpu_torch.ops.roi_align import pallas_geometry, window_starts

    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn(8, 16, 20, 256, generator=g)]
    side = torch.exp(torch.empty(r).uniform_(2.77, 5.77, generator=g))
    y0, x0 = torch.rand(r, generator=g) * 240, torch.rand(r, generator=g) * 300
    rois = torch.stack([y0, x0, (y0 + side).clamp(max=256),
                        (x0 + side * 1.2).clamp(max=320)], 1)
    bi = torch.randint(0, 8, (r,), generator=g, dtype=torch.int32)
    lv = torch.zeros(r, dtype=torch.int32)
    flat, row_ids, by, bx = pallas_geometry(feats, rois, bi, lv, (out, out),
                                            (1.0 / 16,))
    base, stride = window_starts(row_ids)
    return [t.to(dev) for t in (flat, base, stride, by, bx)]


@pytest.mark.parametrize("r,out", [(10, 14), (2048, 7)])
def test_darknet_level_roi_align_matches_plain(cuda, r, out):
    """B2 at the Darknet presets' shapes: 10 ROIs a request
    (``darknet_keypoint``'s ``n_test_post_nms``) at 14x14, 2048 a b8 step
    at 7x7, against the plain version within 1e-5 of its largest value."""
    args = _darknet_level_case(cuda, r, out)
    assert args[3].shape[2] == 24
    got, want = roi_align_fwd(*args), roi_align_region_plain(*args)
    assert got.shape == (r, out, out, 256)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_darknet_level_region_scatter_equals_ordered(cuda):
    """B1 on 2048 train windows of the Darknet level (24x24x256): bit for
    bit ``region_scatter_ordered`` and a second call, every element within
    ``region_scatter_exact``'s rounding bound."""
    from maskrcnn_tpu_torch.ops.roi_align import _d_regions

    flat, base, stride, by, bx = _darknet_level_case(cuda, 2048, 7, seed=1)
    g = torch.randn(2048, 7, 7, 256, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(2))
    d_regs = _d_regions(by, bx, g, torch.float32)
    args = (d_regs, base, stride, flat.shape[0], torch.float32)
    got = region_scatter(*args)
    assert torch.equal(got, region_scatter_ordered(*args))
    assert torch.equal(got, region_scatter(*args))
    exact, bound = region_scatter_exact(*args)
    assert bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("preset", ["tiny_test", "darknet_keypoint"])
def test_darknet_preset_pallas_paths_launch_both_kernels(cuda, preset):
    """One ``roi_align="pallas"`` request (B2 twice) and train step (B2 and
    B1 twice each) of each Darknet preset at its own size, finite."""
    cfg = cfg_lib._rep(cfg_lib.PRESETS[preset](), model=dict(roi_align="pallas"),
                       train=dict(batch_size=2))
    model = MaskRCNN(cfg, seed=0)
    roi_align_fwd.launches = region_scatter.launches = 0
    det = make_predict_fn(cfg, model)(*SyntheticRequests(cfg, seed=0).batch(0))
    assert (roi_align_fwd.launches, region_scatter.launches) == (2, 0)
    assert bool(torch.isfinite(det.boxes).all())
    state = create_train_state(cfg, model)
    roi_align_fwd.launches = region_scatter.launches = 0
    m = make_train_step(cfg)(state, SyntheticDetectionData(cfg, seed=0).batch(0))
    assert (roi_align_fwd.launches, region_scatter.launches) == (2, 2)
    assert all(bool(torch.isfinite(v)) for v in m.values())


# ---- data parallelism and weight import on the card --------------------------

DP_CASES = {  # preset → (config changes, each rank's (B2, B1) launches a step)
    "fpn_mask": (dict(model=dict(n_fg_class=3),
                      proposals=dict(n_train_pre_nms=256, n_train_post_nms=64),
                      sampler=dict(n_sample=32),
                      train=dict(batch_size=2, image_size=(128, 160))), (2, 1)),
    "tiny_test": (dict(model=dict(roi_align="pallas"), train=dict(batch_size=4)),
                  (2, 2)),
}


def _dp_cfg(preset):
    return cfg_lib._rep(cfg_lib.PRESETS[preset](), **DP_CASES[preset][0])


def _quiet(model):
    with torch.no_grad():
        model.rpn_head.conv.weight.zero_()
        model.rpn_head.conv.bias.zero_()
    return model


def _dp_card_rank(rank, world, preset):
    from maskrcnn_tpu_torch.parallel import data_parallel as dp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _dp_cfg(preset)
    model = dp.replicate(_quiet(MaskRCNN(cfg, seed=rank)))
    state = create_train_state(cfg, model, seed=1)
    batch = dp.shard_rows(SyntheticDetectionData(cfg).batch(0), rank, world)
    roi_align_fwd.launches = region_scatter.launches = 0
    metrics = {k: float(v) for k, v in make_train_step(cfg)(state, batch).items()}
    torch.cuda.synchronize()
    return {"metrics": metrics, "launches": (roi_align_fwd.launches,
                                             region_scatter.launches),
            "digest": dp.parameter_digest(model),
            "params": {k: v.detach().cpu() for k, v in model.named_parameters()}}


@pytest.mark.parametrize("preset", sorted(DP_CASES))
def test_two_gloo_ranks_on_the_card_step_as_one_process(cuda, preset, tmp_path):
    """Two processes on the one card, joined by gloo over CUDA tensors, take
    one step of the global batch: each rank launches both kernels on its own
    pyramid, the ranks' parameters are equal in bits, and the step equals
    the 1-process step on the card from the same weights (the RPN's shared
    conv zeroed: the same ROIs) within 1e-3 relative on each loss term and
    1e-3 of the largest update on each parameter (``tiny_test``: Darknet's
    BatchNorms train through sync-BN)."""
    from maskrcnn_tpu_torch.parallel import data_parallel as dp

    torch.backends.cudnn.allow_tf32 = False
    cfg = _dp_cfg(preset)
    model = _quiet(MaskRCNN(cfg, seed=0))
    before = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
    state = create_train_state(cfg, model, seed=1)
    want = {k: float(v) for k, v in make_train_step(cfg)(
        state, SyntheticDetectionData(cfg).batch(0)).items()}
    single = {k: v.detach().cpu() - before[k] for k, v in model.named_parameters()}
    ranks = dp.spawn_ranks(_dp_card_rank, 2, preset, workdir=str(tmp_path))
    assert ranks[0]["digest"] == ranks[1]["digest"]
    largest = max(float(u.abs().max()) for u in single.values())
    for r in ranks:
        assert r["launches"] == DP_CASES[preset][1]
        for k, v in want.items():
            assert r["metrics"][k] == pytest.approx(v, rel=1e-3), k
        for k, u in single.items():
            err = float((r["params"][k] - before[k] - u).abs().max())
            assert err <= 1e-3 * largest, (k, err, largest)


@pytest.mark.parametrize("preset,backbone,head", [
    ("tiny_test", "darknet", "fpn"), ("fpn_mask", "fpn", "fpn")])
def test_pretrained_npz_loads_on_the_card_as_on_the_cpu(cuda, preset, backbone, head,
                                                        tmp_path):
    """An npz emitted in chainer's layout, loaded loosely on the card and on
    the CPU: every tensor equal bit for bit; a request with it runs."""
    import numpy as np

    from maskrcnn_tpu_torch.utils.chainer_npz import emit_model_npz
    from maskrcnn_tpu_torch.utils.convert_chainer import load_pretrained_npz

    cfg = cfg_lib._rep(cfg_lib.PRESETS[preset](),
                       train=dict(batch_size=1, image_size=(128, 160)))
    path = tmp_path / "model.npz"
    np.savez(path, **emit_model_npz(backbone, head, n_fg_class=cfg.model.n_fg_class))
    models = {d: MaskRCNN(cfg, device=d, seed=0) for d in ("cpu", "cuda")}
    for m in models.values():
        load_pretrained_npz(m, str(path), backbone, head, verbose=False)
    want = models["cpu"].state_dict()
    for k, v in models["cuda"].state_dict().items():
        assert torch.equal(v.cpu(), want[k]), k
    det = make_predict_fn(cfg, models["cuda"])(*SyntheticRequests(cfg).batch(0))
    assert bool(torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all())


def _nms_case(lead, n, seed):
    rng = np.random.RandomState(seed)
    yx = rng.uniform(0, 800, lead + (n, 2))
    hw = rng.uniform(4, 200, lead + (n, 2))
    boxes = np.concatenate([yx, yx + hw], -1).astype(np.float32)
    return boxes, rng.rand(*lead, n).astype(np.float32), rng.rand(*lead, n) > 0.1


@pytest.mark.parametrize("lead,n,thresh,n_out", [
    ((), 64, 0.7, 64), ((), 1000, 0.7, 300), ((1,), 12000, 0.7, 2000),
    ((80,), 300, 0.3, 100), ((2, 3), 129, 0.5, 7)])
def test_nms_kernel_equals_the_plain_path(cuda, lead, n, thresh, n_out):
    """``nms_padded`` through the kernel on the card and through the Jacobi
    loop on the CPU: the same (indices, valid), and one launch a call."""
    boxes, scores, valid = _nms_case(lead, n, n)
    out = {}
    for dev in ("cuda", "cpu"):
        before = nms_cuda.nms_greedy.launches
        out[dev] = [x.cpu() for x in nms_padded(
            *(torch.as_tensor(x, device=dev) for x in (boxes, scores)),
            thresh, n_out, torch.as_tensor(valid, device=dev))]
        assert nms_cuda.nms_greedy.launches - before == (dev == "cuda")
    assert out["cpu"][1].any()
    for got, want in zip(out["cuda"], out["cpu"]):
        assert torch.equal(got, want)


def test_nms_kernel_walk_equals_its_transcription(cuda):
    """The kernel's keep mask equals ``nms_keep_bitmask_plain`` on every box,
    the stop at the ``n_out``-th kept box included; pairs exactly at the
    threshold (IoU 0.5 of a 10×10 box and its 10×5 half) do not suppress."""
    rng = np.random.RandomState(1)
    base = rng.uniform(0, 300, (400, 2)).astype(np.float32).round()
    full = np.concatenate([base, base + 10.0], -1)
    half = np.concatenate([base, base + np.array([10.0, 5.0], np.float32)], -1)
    boxes = torch.as_tensor(np.concatenate([full, half])[None])
    valid = torch.as_tensor(rng.rand(1, 800) > 0.05)
    for n_out in (800, 150):
        want = nms_cuda.nms_keep_bitmask_plain(boxes, valid, 0.5, n_out)
        got = nms_cuda.nms_greedy(boxes.cuda(), valid.cuda(), 0.5, n_out).cpu()
        assert torch.equal(got, want), n_out
    assert int(want.sum()) == 150


def _kernel_case(p, n, seed):
    """P problems of N score-sorted boxes, denser problem by problem (so
    the walks stop at different steps), random invalid slots and each odd
    problem's last tenth invalid."""
    rng = np.random.RandomState(seed)
    side = np.linspace(2000.0, 300.0, p)[:, None, None]
    yx = rng.uniform(0, 1, (p, n, 2)) * side
    hw = rng.uniform(8, 120, (p, n, 2))
    boxes = np.concatenate([yx, yx + hw], -1).astype(np.float32)
    valid = rng.rand(p, n) > 0.05
    valid[1::2, n - n // 10:] = False
    return torch.as_tensor(boxes), torch.as_tensor(valid)


def _plain_prefix(boxes, valid, thresh, n_out):
    """The Jacobi spec problem by problem on the card (a P=8 × 12000 call
    at once would hold ~30 GB of pair matrices), up to each n_out-th kept."""
    keep = torch.cat([nms_cuda.nms_keep_plain(b[None], v[None], thresh, n_out)
                      for b, v in zip(boxes.cuda(), valid.cuda())])
    return keep & (torch.cumsum(keep.long(), -1) <= n_out)


@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("n", [64, 300, 6000, 12000])
def test_nms_kernel_equals_the_jacobi_spec_by_batch_and_size(cuda, p, n):
    """One launch of P problems against the Jacobi spec, with ``n_out``
    stopping the walk at its first step, in its middle, and never; each
    call's keep mask is empty past its ``n_out``-th kept box."""
    boxes, valid = _kernel_case(p, n, 7 * p + n)
    for n_out in (1, max(1, n // 6), n):
        want = _plain_prefix(boxes, valid, 0.7, n_out)
        before = nms_cuda.nms_greedy.launches
        got = nms_cuda.nms_greedy(boxes.cuda(), valid.cuda(), 0.7, n_out)
        assert nms_cuda.nms_greedy.launches - before == 1
        assert torch.equal(got, want), (p, n, n_out)
    steps = nms_cuda.nms_work(want, n)["steps"]
    assert len(steps) == p and max(steps) == -(-n // 64)


@pytest.mark.parametrize("n", [15000, 20000])
def test_nms_kernel_reads_unstaged_tiles_in_place(cuda, n):
    """Above 14336 boxes two buffers of the first tiles' rows do not fit in
    shared memory: those tiles (11 of 235 at 15000, 90 of 313 at 20000)
    are read from global memory, the rest staged; the keep masks still
    equal the Jacobi spec's."""
    boxes, valid = _kernel_case(2, n, n)
    for n_out in (n // 5, n):
        got = nms_cuda.nms_greedy(boxes.cuda(), valid.cuda(), 0.7, n_out)
        assert torch.equal(got, _plain_prefix(boxes, valid, 0.7, n_out)), n_out


def test_nms_parts_equal_the_whole_call(cuda):
    """The mask pass and the walk launched apart (as ``chip_smoke.py``
    times them) give the whole call's keep mask, one launch each."""
    boxes, valid = _kernel_case(2, 3000, 5)
    want = nms_cuda.nms_greedy(boxes.cuda(), valid.cuda(), 0.7, 500)
    before = nms_cuda.nms_greedy.launches
    mask_pass, walk = nms_cuda.nms_greedy.parts(boxes.cuda(), valid.cuda(), 0.7, 500)
    mask_pass()
    assert torch.equal(walk(), want)
    assert nms_cuda.nms_greedy.launches - before == 2


def test_batched_proposals_capture_equals_eager(cuda):
    """``generate_proposals`` over a b2 batch at the train budgets
    (12000/2000 of a 256×320 canvas's 20460 anchors), captured into a CUDA
    graph and replayed, equals its eager run in every bit; the capture
    launches NMS once for both images."""
    from maskrcnn_tpu_torch.models.maskrcnn import backbone_geometry, pyramid_shapes
    from maskrcnn_tpu_torch.models.rpn import anchors_for, generate_proposals

    cfg = cfg_lib.fpn_mask()
    shapes = pyramid_shapes(cfg, (256, 320))
    anchors = torch.as_tensor(anchors_for(cfg, shapes, backbone_geometry(cfg)[0]),
                              device=cuda)
    rng = np.random.RandomState(3)
    a = anchors.shape[0]
    args = [torch.as_tensor(x, device=cuda) for x in (
        (rng.normal(size=(2, a, 4)) * 0.2).astype(np.float32),
        rng.normal(size=(2, a, 2)).astype(np.float32),
        np.array([1.0, 0.6], np.float32),
        np.array([[256, 320], [180, 300]], np.float32))]
    kw = dict(n_pre=12000, n_post=2000, nms_thresh=0.7, min_size=16.0, n_levels=5)

    def run():
        return generate_proposals(args[0], args[1], anchors, args[2], args[3], **kw)

    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = nms_cuda.nms_greedy.launches
    with torch.cuda.graph(graph):
        captured = run()
    assert nms_cuda.nms_greedy.launches - before == 1
    graph.replay()
    torch.cuda.synchronize()
    assert eager.valid.sum() > 1000
    for name, g, w in zip(eager._fields, captured, eager):
        assert torch.equal(g, w), name


def _chain_cfg():
    return cfg_lib._rep(
        cfg_lib.fpn_mask(), model=dict(n_fg_class=3),
        proposals=dict(n_train_pre_nms=256, n_train_post_nms=64),
        sampler=dict(n_sample=32),
        train=dict(batch_size=2, image_size=(128, 128)))


def test_chain_of_four_equals_four_eager_steps(cuda):
    """``make_train_step(chain=4)``'s first call (an eager step, the
    capture, three replays) and a second (four replays) against eight eager
    steps from a copy of the state, under deterministic algorithms: equal
    in every bit, metrics stacked (4,), the generator alike."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = _chain_cfg()
    data = SyntheticDetectionData(cfg)
    raw = [data.batch(i) for i in range(8)]
    stacked = [type(raw[0])(*(None if x[0] is None else np.stack(x)
                              for x in zip(*raw[i:i + 4]))) for i in (0, 4)]
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager, graphed = (create_train_state(cfg, MaskRCNN(cfg, seed=0), 1)
                          for _ in range(2))
        step, chained = make_train_step(cfg), make_train_step(cfg, chain=4)
        rows = [step(eager, b) for b in raw]
        metrics = [chained(graphed, b) for b in stacked]
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    assert graphed.step == eager.step == 8
    for name in rows[0]:
        got = torch.cat([m[name] for m in metrics])
        assert got.shape == (8,)
        assert torch.equal(got, torch.stack([r[name] for r in rows])), name
    for (name, a), b in zip(eager.model.state_dict().items(),
                            graphed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert torch.equal(eager.generator.get_state(), graphed.generator.get_state())


def test_chain_counters_count_replays(cuda):
    """A replayed graph launches what its capture recorded: each chain of
    four adds B2 2, B1 1 and NMS 1 a step (both images' proposals in one
    call), the capture none of its own."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = _chain_cfg()
    data = SyntheticDetectionData(cfg)
    raw = [data.batch(i) for i in range(4)]
    stacked = type(raw[0])(*(None if x[0] is None else np.stack(x)
                             for x in zip(*raw)))
    state = create_train_state(cfg, MaskRCNN(cfg, seed=0), 1)
    chained = make_train_step(cfg, chain=4)
    for _ in range(2):  # the first call captures, the second only replays
        for kernel in step_mod.KERNELS:
            kernel.launches = 0
        chained(state, stacked)
        assert [k.launches for k in step_mod.KERNELS] == [8, 4, 4]


def _graph_cfg(preset, dtype="float32", roi_align="auto"):
    """A request small enough for a test: ``tiny_test`` at its own 128×160,
    ``darknet_keypoint`` at its own 256×320 (one class keeping 10 boxes:
    pass 2 runs on 11 of the 100 slots), ``fpn_mask`` at 256×320 with 3
    classes; b1."""
    model = dict(dtype=dtype, roi_align=roi_align)
    if preset == "tiny_test":
        return cfg_lib._rep(cfg_lib.tiny_test(), model=model,
                            train=dict(batch_size=1, image_size=(128, 160)))
    if preset == "darknet_keypoint":
        return cfg_lib._rep(cfg_lib.darknet_keypoint(), model=model,
                            train=dict(batch_size=1, image_size=(256, 320)))
    return cfg_lib._rep(
        cfg_lib.fpn_mask(), model=dict(n_fg_class=3, **model),
        proposals=dict(n_test_pre_nms=512, n_test_post_nms=64),
        eval=dict(max_detections=16), train=dict(batch_size=1, image_size=(256, 320)))


def _graph_setup(cuda, preset, dtype="float32", roi_align="auto", n=4):
    """(model with spread class scores, its predict, n seeded requests)."""
    from maskrcnn_tpu_torch.bench import spread_class_scores

    torch.backends.cudnn.allow_tf32 = False
    cfg = _graph_cfg(preset, dtype, roi_align)
    model = spread_class_scores(MaskRCNN(cfg, device=cuda, seed=0))
    data = SyntheticRequests(cfg)
    return model, make_predict_fn(cfg, model), [tuple(data.batch(i)) for i in range(n)]


def _same(got, want):
    for name, g, w in zip(got._fields, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preset", ["tiny_test", "fpn_mask", "darknet_keypoint"])
def test_graphed_predict_equals_eager_bit_for_bit(cuda, preset, dtype):
    """The warm-up, the capture's first replay and later replays each equal
    ``predict.eager`` on the same request in every bit; on
    ``darknet_keypoint`` with pass 2 on 11 rows and its last row filling
    the 89 padding slots after them."""
    _, predict, requests = _graph_setup(cuda, preset, dtype)
    for req in requests:
        det = predict(*req)
        _same(det, predict.eager(*req))
    graph, = predict.graphs.values()
    assert (graph.captures, graph.replays) == (1, len(requests) - 1)
    assert det.valid.any()
    if preset == "darknet_keypoint":
        heat = det.heatmaps
        assert heat.shape == (1, 100, 56, 56, 20) and not det.valid[:, 10:].any()
        assert torch.equal(heat[:, 10:], heat[:, 10:11].expand_as(heat[:, 10:]))


def test_first_call_warms_up_second_captures_third_replays(cuda):
    _, predict, requests = _graph_setup(cuda, "tiny_test")
    predict(*requests[0])
    graph, = predict.graphs.values()
    assert graph.graph is None and (graph.captures, graph.replays) == (0, 0)
    predict(*requests[1])
    assert (graph.captures, graph.replays) == (1, 1)
    assert graph.capture_s > 0 and graph.reserved_bytes > 0
    captured = graph.graph
    predict(*requests[2])
    assert graph.graph is captured and (graph.captures, graph.replays) == (1, 2)
    # a b2 request is a signature of its own: it warms up, nothing captured
    images, img_hw, scale = (np.concatenate([a, b]) for a, b in zip(*requests[:2]))
    predict(images, img_hw, scale)
    assert len(predict.graphs) == 2 and graph.replays == 2


def test_replaced_parameter_recaptures_in_place_update_does_not(cuda):
    """A parameter replaced by another tensor makes the next call capture
    again; one updated in place (an optimizer step, ``load_state_dict``)
    does not, and the replay reads its new values."""
    from maskrcnn_tpu_torch.bench import class_score_layer

    model, predict, requests = _graph_setup(cuda, "fpn_mask")
    req = requests[0]
    predict(*req)
    before = predict(*req)
    graph, = predict.graphs.values()
    layer = class_score_layer(model)
    layer.weight = torch.nn.Parameter(layer.weight.detach() * 1.5)
    replaced = predict(*req)
    assert graph.captures == 2
    _same(replaced, predict.eager(*req))
    assert not torch.equal(replaced.scores, before.scores)
    with torch.no_grad():
        layer.weight.mul_(0.5)
    updated = predict(*req)
    assert graph.captures == 2
    _same(updated, predict.eager(*req))
    assert not torch.equal(updated.scores, replaced.scores)


@pytest.mark.parametrize("preset,roi_align,want", [
    ("fpn_mask", "auto", [2, 0, 2]), ("tiny_test", "auto", [0, 0, 2]),
    ("tiny_test", "pallas", [2, 0, 2])])
def test_replay_counts_the_launches_of_an_eager_request(cuda, preset, roi_align,
                                                        want):
    _, predict, requests = _graph_setup(cuda, preset, roi_align=roi_align, n=2)
    for req in requests:  # the warm-up and the capture
        predict(*req)
    counts = []
    for fn in (predict, predict.eager):
        for kernel in step_mod.KERNELS:
            kernel.launches = 0
        fn(*requests[0])
        counts.append([k.launches for k in step_mod.KERNELS])
    assert counts == [want, want]


def test_two_replayed_results_never_alias(cuda):
    _, predict, requests = _graph_setup(cuda, "tiny_test")
    for req in requests[:2]:
        predict(*req)
    first, second = predict(*requests[0]), predict(*requests[1])
    _same(first, predict.eager(*requests[0]))
    for name, a, b in zip(first._fields, first, second):
        if a is not None:
            assert a.data_ptr() != b.data_ptr(), name
    assert not torch.equal(first.scores, second.scores)


def test_capture_that_waits_for_the_host_raises(cuda, monkeypatch):
    """A body that reads a value on the host runs eagerly (the warm-up),
    but its capture raises naming the operation, every time: nothing falls
    back to eager."""
    from maskrcnn_tpu_torch.eval import predict as predict_mod

    merge_top = predict_mod.merge_top

    def waits(cls_boxes, *args):
        if cls_boxes.sum().item() < 0:  # reads the device's value
            raise AssertionError
        return merge_top(cls_boxes, *args)

    monkeypatch.setattr(predict_mod, "merge_top", waits)
    _, predict, requests = _graph_setup(cuda, "tiny_test")
    predict(*requests[0])
    for req in requests[1:3]:
        with pytest.raises(RuntimeError, match=r"capturing the request into a "
                           r"CUDA graph failed at \S*test_torch_cuda\.py:\d+ "
                           r"\(if cls_boxes\.sum\(\)\.item\(\) < 0:"):
            predict(*req)
    graph, = predict.graphs.values()
    assert graph.graph is None and graph.replays == 0
    torch.cuda.synchronize()
    assert float(torch.ones(4, device=cuda).sum()) == 4.0


def _kernels_of(fn):
    """Device kernels that ``fn()`` runs, by name: copies, sets and the
    device-side annotations of the program's spans left out. Read from the
    second of two profiled calls: the process's first profiled stretch can
    hold activity of the tracer's own start."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return Counter(e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset", "predict", "capture")))


@pytest.mark.parametrize("preset", ["tiny_test", "fpn_mask"])
def test_traced_replay_equals_untraced_counts_and_times_its_stages(cuda, preset):
    """With tracing on a request replays a graph of its own, captured with
    the stage events and counters: its detections equal the untraced
    replay's and ``predict.eager``'s in every bit, its five stages read
    positive device ms from the graph's events, and N replays count N times
    what an eager request counts. The traced graph runs the counters'
    kernels beyond the untraced one's, as many as an eager request traced
    runs beyond one untraced. Switching tracing off replays the untraced
    graph again, with no new capture."""
    from maskrcnn_tpu_torch.utils import tracing

    _, predict, requests = _graph_setup(cuda, preset, n=3)
    req = requests[2]
    try:
        for r in requests[:2]:  # the untraced graph: warm-up, capture
            predict(*r)
        plain = predict(*req)
        untraced, = predict.graphs.values()
        plain_kernels = (_kernels_of(lambda: predict(*req)),
                         _kernels_of(lambda: predict.eager(*req)))
        replays = untraced.replays
        tracing.reset()
        tracing.enable()
        for r in requests[:2]:  # the traced graph: warm-up, capture
            predict(*r)
        assert len(predict.graphs) == 2 and untraced.replays == replays
        tracing.reset()
        predict.eager(*req)
        per_request = tracing.summary()["counters"]
        assert per_request["detection_slots"] == _graph_cfg(preset).eval.max_detections
        assert per_request["detections_valid"] > 0
        tracing.reset()
        n = 3
        for _ in range(n):
            _same(predict(*req), plain)
        s = tracing.summary()
        assert s["counters"] == {k: n * v for k, v in per_request.items()}
        assert s["stage_kinds"] == ["graph"] and s["units"] == n
        assert list(s["stages_ms"]) == ["backbone", "proposals", "box_head",
                                        "detections", "mask_head"]
        assert all(ms > 0 for ms in s["stages_ms"].values())
        assert s["spans_ms"]["predict.replay"]["n"] == n
        _same(predict.eager(*req), plain)
        traced_graph = next(g for key, g in predict.graphs.items() if key[-1])
        traced_kernels = (_kernels_of(lambda: predict(*req)),
                          _kernels_of(lambda: predict.eager(*req)))
        extra = traced_kernels[0] - plain_kernels[0]  # the counters' kernels
        assert extra and extra == traced_kernels[1] - plain_kernels[1], (
            extra, traced_kernels[1] - plain_kernels[1], plain_kernels[0] - traced_kernels[0])
        tracing.disable()
        captures, replays = untraced.captures, untraced.replays
        _same(predict(*req), plain)
        assert (untraced.captures, untraced.replays) == (captures, replays + 1)
        assert traced_graph.captures == 1 and len(predict.graphs) == 2
    finally:
        tracing.disable()
        tracing.reset()


def test_traced_chain_updates_as_the_untraced_one(cuda, monkeypatch):
    """Two chains of four from one seed, one traced from its capture on:
    the same parameters and momentum in every bit (deterministic
    algorithms), six positive stages a replayed step, a capture span, and
    counters of the replayed steps; switching the flag recaptures."""
    from maskrcnn_tpu_torch.utils import tracing

    torch.backends.cudnn.allow_tf32 = False
    cfg = _chain_cfg()
    data = SyntheticDetectionData(cfg)
    raw = [data.batch(i) for i in range(4)]
    stacked = type(raw[0])(*(None if x[0] is None else np.stack(x)
                             for x in zip(*raw)))
    made = []
    init = step_mod.GraphedStep.__init__

    def counted(self, *args):
        made.append(tracing.is_on())
        init(self, *args)

    monkeypatch.setattr(step_mod.GraphedStep, "__init__", counted)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    states = []
    try:
        for on in (False, True):
            tracing.reset()
            (tracing.enable if on else tracing.disable)()
            state = create_train_state(cfg, MaskRCNN(cfg, seed=0), 1)
            chained = make_train_step(cfg, chain=4)
            chained(state, stacked)
            states.append(({n: t.clone() for n, t in state.model.state_dict().items()},
                           [state.optimizer.state[p]["momentum_buffer"].clone()
                            for p in state.model.parameters() if p in state.optimizer.state]))
        s = tracing.summary()
        chained(state, stacked)  # traced again: replays only
        tracing.disable()
        chained(state, stacked)  # the flag differs from the capture's
    finally:
        tracing.disable()
        tracing.reset()
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
    (plain, plain_momentum), (traced, traced_momentum) = states
    for name, a in plain.items():
        assert torch.equal(a, traced[name]), name
    for a, b in zip(plain_momentum, traced_momentum):
        assert torch.equal(a, b)
    assert made == [False, True, False]
    assert s["spans_ms"]["capture"]["n"] == 1 and s["spans_ms"]["train.replay"]["n"] == 3
    assert s["stage_kinds"] == ["eager", "graph"] and s["units"] == 4
    assert list(s["stages_ms"]) == ["forward", "proposals", "targets", "heads",
                                    "backward", "optimizer"]
    assert all(ms > 0 for ms in s["stages_ms"].values())
    assert s["counters"]["mask_roi_slots"] == 4 * 2 * 8  # n_pos_cap 8, b2, 4 steps
    assert s["counters"]["proposal_slots"] == 4 * 2 * 64
    assert state.step == 12


class _ConvFlags:
    """Forward hooks on every convolution of a model: for each call, whether
    the current stream was capturing and whether cuDNN's timing was on."""

    def __init__(self, model):
        from maskrcnn_tpu_torch.models.layers import Conv2d, ConvTranspose2d

        self.calls = []
        self.handles = [m.register_forward_hook(self.hook) for m in model.modules()
                        if isinstance(m, (Conv2d, ConvTranspose2d))]

    def hook(self, module, inputs, output):
        self.calls.append((torch.cuda.is_current_stream_capturing(),
                           torch.backends.cudnn.benchmark))

    def remove(self):
        for h in self.handles:
            h.remove()


def _fresh_tracer():
    from maskrcnn_tpu_torch.utils import tracing

    tracing.disable()
    tracing.reset()
    tracing.TRACER.seen.clear()
    return tracing


def test_tuned_request_replays_equal_eager_and_no_capture_times(cuda):
    """cuDNN times every convolution of the warm-up (``conv_problems_tuned``
    counts them, ``conv_problems_untuned`` nothing), the capture runs with
    the timing off, so that it reuses the engines the warm-up chose and
    calls no search, and each replay equals ``predict.eager`` in every
    bit."""
    model, predict, requests = _graph_setup(cuda, "fpn_mask")
    tracing = _fresh_tracer()
    flags = _ConvFlags(model)
    try:
        tracing.enable()
        for req in requests:
            _same(predict(*req), predict.eager(*req))
        counters = tracing.summary()["counters"]
    finally:
        flags.remove()
        tracing.disable()
        tracing.reset()
    captured = [on for capturing, on in flags.calls if capturing]
    eager = [on for capturing, on in flags.calls if not capturing]
    assert captured and not any(captured)
    assert eager and all(eager)
    assert counters["conv_problems_tuned"] > 0 and "conv_problems_untuned" not in counters
    assert torch.backends.cudnn.benchmark is False


def test_tuned_chain_times_its_eager_step_and_not_its_capture(cuda):
    """The chain's eager step runs its convolutions with cuDNN's timing on
    (forward, and the backward's dgrad and wgrad inside the same scope), the
    capture with it off; every problem counts as tuned."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = _chain_cfg()
    data = SyntheticDetectionData(cfg)
    raw = [data.batch(i) for i in range(4)]
    stacked = type(raw[0])(*(None if x[0] is None else np.stack(x)
                             for x in zip(*raw)))
    state = create_train_state(cfg, MaskRCNN(cfg, seed=0), 1)
    tracing = _fresh_tracer()
    flags = _ConvFlags(state.model)
    try:
        tracing.enable()
        metrics = make_train_step(cfg, chain=4)(state, stacked)
        counters = tracing.summary()["counters"]
    finally:
        flags.remove()
        tracing.disable()
        tracing.reset()
    captured = [on for capturing, on in flags.calls if capturing]
    eager = [on for capturing, on in flags.calls if not capturing]
    assert captured and not any(captured)
    assert eager and all(eager)
    assert counters["conv_problems_tuned"] > 0 and "conv_problems_untuned" not in counters
    assert bool(torch.isfinite(metrics["loss"]).all())
    assert torch.backends.cudnn.benchmark is False


def _conv_error(dev, allow_tf32):
    """A 3×3 float32 convolution at a backbone's size (b2, 256 channels,
    100×128, channels-last; 30 GFLOP a pass) and its input and weight
    gradients, timed by cuDNN, against the same in float64: the largest
    relative error of the three, each over its own norm."""
    from maskrcnn_tpu_torch.models.layers import tuned_convolutions

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(2, 256, 100, 128, device=dev, generator=g).contiguous(
        memory_format=torch.channels_last)
    w = (torch.randn(256, 256, 3, 3, device=dev, generator=g) / 48).contiguous(
        memory_format=torch.channels_last)
    dy = torch.randn(2, 256, 100, 128, device=dev, generator=g).contiguous(
        memory_format=torch.channels_last)

    def run(x, w, dy):
        x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
        y = torch.nn.functional.conv2d(x, w, padding=1)
        return (y, *torch.autograd.grad(y, (x, w), dy))

    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        with tuned_convolutions():
            got = run(x, w, dy)
            got = run(x, w, dy)  # the cached engines
    finally:
        torch.backends.cudnn.allow_tf32 = before
    want = run(x.double(), w.double(), dy.double())
    return max(float((a.double() - b).norm() / b.norm()) for a, b in zip(got, want))


def test_tuned_float32_convolution_stays_within_float32_error(cuda):
    """With TF32 off, cuDNN's timed engines for a large float32 convolution,
    its dgrad and its wgrad stay within float32's error of float64 (no
    tensor-core engine was chosen); the same search with TF32 allowed reads
    over a hundred times more."""
    f32 = _conv_error(cuda, allow_tf32=False)
    tf32 = _conv_error(cuda, allow_tf32=True)
    print(f"relative error: float32 {f32:.3g}, TF32 allowed {tf32:.3g}")
    assert f32 < 1e-5
    assert tf32 > 1e-4
