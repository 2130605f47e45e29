"""The port's region scatter and shared train pool against the JAX package.

- ``region_scatter_plain`` (what the CUDA kernel's wrapper runs on CPU
  tensors, and the spec the kernel is held against on the card) against the
  TPU kernel ``scatter_add_regions(..., interpret=True)`` and a numpy loop,
  on the inputs of ``tests/test_kernels.py``, including the out-of-range
  drop;
- ``multilevel_roi_align_train`` values and feature gradients against
  JAX's ``bwd_scatter="xla"`` and ``"pallas"``; gradients within rtol 1e-3 /
  atol 1e-4, the JAX package's own bound between its two backwards (float32
  summation order);
- a P6 ROI of the last image, whose window runs past the buffer's end.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu.kernels.region_scatter_pallas import scatter_add_regions  # noqa: E402
from maskrcnn_tpu.ops.roi_align import (  # noqa: E402
    multilevel_roi_align_train as jax_roi_align_train,
)
from maskrcnn_tpu_torch.kernels.region_scatter_cuda import (  # noqa: E402
    region_scatter,
    region_scatter_exact,
    region_scatter_plain,
    scatter_rows,
)
from maskrcnn_tpu_torch.ops import roi_align as tra  # noqa: E402

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)


def _port_layout(d, base2, stride2, t, txn, n_half=1):
    """The TPU kernel's 128-lane rows → the port's (R, t, tx, C) windows:
    with C = 128·n_half, ``txn = tx·n_half`` and row indices scale by
    ``n_half``."""
    r = d.shape[0]
    tx = txn // n_half
    return (torch.from_numpy(d.reshape(r, t, tx, 128 * n_half)),
            torch.from_numpy(base2 // n_half), torch.from_numpy(stride2 // n_half))


@pytest.mark.parametrize("n_half", [1, 2])
def test_plain_scatter_matches_tpu_kernel_and_numpy(n_half):
    rng = np.random.RandomState(0)
    R, t, txn, S2 = 53, 6, 16, 4096
    d = rng.randn(R, t * txn, 128).astype(np.float32)
    stride = rng.choice([8, 16, 32, 64], R).astype(np.int32)
    base = (rng.randint(0, (S2 - 8) // 8, R) * 8).astype(np.int32)
    halo = (t - 1) * 64 + txn

    ref = np.zeros((S2 + halo + 64, 128), np.float32)
    for r in range(R):
        for j in range(t):
            o = base[r] + j * stride[r]
            ref[o:o + txn] += d[r, j * txn:(j + 1) * txn]

    want = np.asarray(scatter_add_regions(
        jnp.asarray(d), jnp.asarray(base), jnp.asarray(stride),
        s2_rows=S2, t=t, txn=txn, halo=halo, out_dtype=jnp.float32,
        interpret=True))
    got = region_scatter_plain(*_port_layout(d, base, stride, t, txn, n_half),
                               S2 // n_half)
    assert got.shape == (S2 // n_half, 128 * n_half) and got.is_contiguous()
    got = got.numpy().reshape(S2, 128)
    np.testing.assert_allclose(got, ref[:S2], atol=1e-4)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # some windows of this case do run past the end and are dropped there
    assert (base + (t - 1) * stride + txn > S2).any()


def test_plain_scatter_drops_rows_out_of_range():
    """Rows at or past ``s_rows`` and rows before 0 are dropped, not wrapped
    or clamped; rows inside accumulate."""
    t, txn, S2 = 3, 8, 256
    d = np.ones((1, t * txn, 128), np.float32)
    base = np.array([S2 - 16], np.int32)  # the third window row exits
    stride = np.array([8], np.int32)
    want = np.asarray(scatter_add_regions(
        jnp.asarray(d), jnp.asarray(base), jnp.asarray(stride),
        s2_rows=S2, t=t, txn=txn, halo=t * 8 + txn, out_dtype=jnp.float32,
        interpret=True))
    got = region_scatter_plain(*_port_layout(d, base, stride, t, txn), S2).numpy()
    np.testing.assert_array_equal(got, want)
    # window rows 0 and 1 fill the last 16 rows once; row 2 is dropped
    assert got[:S2 - 16].sum() == 0 and (got[S2 - 16:] == 1).all()

    # a window that starts before the buffer: only its inside rows land
    d_regs = torch.ones(1, 2, 4, 8)
    got = region_scatter_plain(d_regs, torch.tensor([-2], dtype=torch.int32),
                               torch.tensor([3], dtype=torch.int32), 4)
    assert got[:, 0].tolist() == [1.0, 2.0, 1.0, 1.0]
    rows = scatter_rows(torch.tensor([-2]), torch.tensor([3]), 2, 4, 4)
    assert rows.tolist() == [[[4, 4, 0, 1], [1, 2, 3, 4]]]  # 4 is the sink


def _bf16_case(rng, R=40, t=5, txn=32, S2=4096, integers=False):
    """The TPU kernel's inputs in bf16 with 16-row alignment (its bf16
    accumulator moves rows in 16-row chunks)."""
    d = rng.randn(R, t * txn, 128)
    if integers:
        d = np.clip(np.round(d), -1, 1)
    # bf16 values, held in float32 arrays
    d = np.array(jnp.asarray(d.astype(np.float32)).astype(jnp.bfloat16)
                 .astype(jnp.float32))
    stride = rng.choice([16, 32, 64], R).astype(np.int32)
    base = (rng.randint(0, (S2 - 16) // 16, R) * 16).astype(np.int32)
    return d, base, stride, (t - 1) * 64 + txn


def _tpu_scatter(d, base, stride, S2, t, txn, halo, acc):
    return np.asarray(scatter_add_regions(
        jnp.asarray(d).astype(jnp.bfloat16), jnp.asarray(base),
        jnp.asarray(stride), s2_rows=S2, t=t, txn=txn, halo=halo,
        out_dtype=jnp.bfloat16, acc_dtype=acc,
        interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_half", [1, 2])
def test_plain_scatter_bf16_matches_tpu_kernel(acc, n_half):
    """bf16 cotangents to a bf16 gradient, summed in float32 or bf16, as
    ``scatter_add_regions(..., out_dtype=bfloat16, acc_dtype=...)``.
    Integer values add exactly in either accumulator, whatever the order:
    bit for bit. Random values: a float32 sum differs only by where the
    final bf16 rounding falls (one bf16 step, 2^-8 of the value); a bf16
    accumulator rounds every partial sum, and the two add the ROIs in
    another order (TPU: sorted by base), so an element that sums k terms
    can move by k/2 steps of its partial sums: 2^-8·k/2 of max|exact|, with
    k the most windows that meet on a row, and the mean error under a tenth
    of that."""
    rng = np.random.RandomState(1)
    t, txn, S2 = 5, 32, 4096
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[acc]
    for integers in (True, False):
        d, base, stride, halo = _bf16_case(rng, t=t, txn=txn, S2=S2,
                                           integers=integers)
        want = _tpu_scatter(d, base, stride, S2, t, txn, halo, acc)
        regs, b, st = _port_layout(d, base, stride, t, txn, n_half)
        got = region_scatter_plain(regs.to(torch.bfloat16), b, st,
                                   S2 // n_half, tdt)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy().reshape(S2, 128)
        exact = region_scatter_plain(regs.double(), b, st, S2 // n_half,
                                     torch.float64).numpy().reshape(S2, 128)
        if integers:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, exact)
            continue
        scale = float(np.abs(exact).max())
        step = 2.0 ** -8 * scale
        meet = float(region_scatter_plain(torch.ones_like(regs), b, st,
                                          S2 // n_half).max())
        assert meet >= 3
        k = 1 if acc == "float32" else meet / 2
        _, bound = region_scatter_exact(regs.to(torch.bfloat16), b, st,
                                        S2 // n_half, tdt)
        bound = bound.numpy().reshape(S2, 128)
        for out in (got, want):
            err = np.abs(out - exact)
            assert float(err.max()) <= k * step, (acc, float(err.max()), step)
            assert float(err.mean()) <= 0.1 * k * step
            assert (err <= bound).all()  # and element by element


def test_plain_bf16_accumulator_rounds_every_add():
    """A bf16 accumulator rounds after each add, in ROI order: 256 plus
    sixteen ones stays 256 (one is half a bf16 step there), where a float32
    accumulator gives 272; on random overlapping windows the plain version
    equals a Python loop over the window elements bit for bit."""
    ones = torch.ones(17, 1, 1, 8, dtype=torch.bfloat16)
    ones[0] = 256
    zero = torch.zeros(17, dtype=torch.int32)
    assert region_scatter_plain(ones, zero, zero, 2, torch.bfloat16)[0, 0] == 256
    assert region_scatter_plain(ones, zero, zero, 2, torch.float32)[0, 0] == 272

    g = torch.Generator().manual_seed(0)
    d_regs = torch.randn(30, 3, 4, 8, generator=g).bfloat16()
    base = torch.randint(-3, 10, (30,), generator=g, dtype=torch.int32)
    stride = torch.randint(0, 5, (30,), generator=g, dtype=torch.int32)
    rows = scatter_rows(base, stride, 3, 4, 20).reshape(-1)
    want = torch.zeros(21, 8, dtype=torch.bfloat16)
    for row, term in zip(rows.tolist(), d_regs.reshape(-1, 8)):
        want[row] = (want[row].float() + term.float()).bfloat16()
    got = region_scatter_plain(d_regs, base, stride, 20, torch.bfloat16)
    assert torch.equal(got, want[:20])


@pytest.mark.parametrize("dtype,acc", [
    ("float32", "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16")])
def test_exact_bound_holds_for_the_plain_version_and_catches_wrong_sums(dtype, acc):
    """``region_scatter_exact``'s per-element bound, the criterion the card
    holds the kernel to: the plain version (one rounded add after another
    in ``acc``) lies within it; an output that drops one window, moves one
    window a row down or is all zero does not."""
    dtype, acc = getattr(torch, dtype), getattr(torch, acc)
    g = torch.Generator().manual_seed(0)
    r, t, tx, c, s_rows = 60, 4, 8, 16, 300
    d_regs = torch.randn(r, t, tx, c, generator=g)
    d_regs[:, :, tx // 2:] = 0  # zero vectors, as outside a ROI's extent
    d_regs = d_regs.to(dtype)
    base = torch.randint(-5, 200, (r,), generator=g, dtype=torch.int32)
    base[:20] = torch.randint(0, 8, (20,), generator=g, dtype=torch.int32)
    stride = torch.randint(0, 24, (r,), generator=g, dtype=torch.int32)
    exact, bound = region_scatter_exact(d_regs, base, stride, s_rows, acc)
    assert exact.dtype == bound.dtype == torch.float64
    assert float(bound.max()) > 0  # where windows meet, the adds round

    def within(out):
        return bool(((out.double() - exact).abs() <= bound).all())

    plain = region_scatter_plain(d_regs, base, stride, s_rows, acc)
    assert within(plain)
    dropped = d_regs.clone()
    dropped[30] = 0
    assert not within(region_scatter_plain(dropped, base, stride, s_rows, acc))
    moved = base.clone()
    moved[30] += 1
    assert not within(region_scatter_plain(d_regs, moved, stride, s_rows, acc))
    assert not within(torch.zeros_like(plain))


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    d_regs = torch.randn(3, 2, 4, 8)
    base = torch.tensor([0, 5, 9], dtype=torch.int32)
    stride = torch.tensor([4, 4, 4], dtype=torch.int32)
    before = region_scatter.launches
    got = region_scatter(d_regs, base, stride, 16)
    assert torch.equal(got, region_scatter_plain(d_regs, base, stride, 16))
    assert region_scatter.launches == before  # no kernel was launched
    with pytest.raises(ValueError, match="unsupported device"):
        region_scatter(d_regs.to("meta"), base.to("meta"), stride.to("meta"), 16)


def _pair_case(rng, shapes, scales, b=2, c=256, n=12, n_pos=4, rois=None,
               levels=None):
    feats = [rng.randn(b, h, w, c).astype(np.float32) for h, w in shapes]
    if rois is None:
        yx = rng.uniform(0, 100, (b, n, 2))
        hw = rng.uniform(8, 50, (b, n, 2))
        rois = np.concatenate([yx, yx + hw], -1).astype(np.float32)
        levels = rng.randint(0, len(shapes), (b, n)).astype(np.int32)
    return feats, rois, levels, n_pos, scales


def _objective(pb, pm, cos):
    return (pb ** 2).sum() + (pm * cos(pm)).sum()


def _jax_pair(case, bwd):
    feats, rois, levels, n_pos, scales = case

    def f(fs):
        pb, pm = jax_roi_align_train(
            fs, jnp.asarray(rois), jnp.asarray(levels), n_pos, (7, 7),
            (14, 14), scales, bwd_scatter=bwd)
        return _objective(pb, pm, jnp.cos), (pb, pm)

    (_, outs), grads = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(x) for x in feats])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_pair(case):
    feats, rois, levels, n_pos, scales = case
    fs = [torch.from_numpy(x).requires_grad_() for x in feats]
    before = region_scatter.launches
    pb, pm = tra.multilevel_roi_align_train(
        fs, torch.from_numpy(rois), torch.from_numpy(levels), n_pos, (7, 7),
        (14, 14), scales)
    _objective(pb, pm, torch.cos).backward()
    assert region_scatter.launches == before  # CPU tensors: the plain version
    return ([pb.detach().numpy(), pm.detach().numpy()],
            [f.grad.numpy() for f in fs])


@pytest.mark.parametrize("bwd", ["xla", "pallas"])
def test_train_pair_values_and_gradients_match_jax(bwd):
    """The shapes of ``tests/test_kernels.py``'s fused-pair test: three
    levels with widths divisible by 8 (fold 8, 20×32 windows), C = 256."""
    case = _pair_case(np.random.RandomState(0),
                      [(32, 40), (16, 24), (8, 16)], (0.25, 0.125, 0.0625))
    (pb, pm), grads = _port_pair(case)
    (jpb, jpm), jgrads = _jax_pair(case, bwd)
    assert pb.shape == (24, 7, 7, 256) and pm.shape == (8, 14, 14, 256)
    np.testing.assert_allclose(pb, jpb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pm, jpm, rtol=1e-5, atol=1e-5)
    for g, jg in zip(grads, jgrads):
        assert float(np.abs(jg).max()) > 0
        np.testing.assert_allclose(g, jg, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("acc", ["float32", "bfloat16"])
def test_train_pair_bf16_matches_jax(acc):
    """bf16 features through the shared pool and back, against JAX's fused
    pair (``bwd_scatter="pallas"``, ``acc_dtype``) on the same bf16 values.
    The gradient comes back in bf16. JAX rounds its Kronecker weights to
    bf16 in the forward (the port keeps them float32) and contracts
    ``Byᵀ·g·Bx`` in one product where the port rounds after ``Byᵀ·g``:
    pooled values within 1e-2 of max|JAX|, gradients within 3e-2 of their
    max and 3e-3 on average (a bf16 step is 2^-8 = 3.9e-3)."""
    feats, rois, levels, n_pos, scales = _pair_case(
        np.random.RandomState(0), [(32, 40), (16, 24), (8, 16)],
        (0.25, 0.125, 0.0625))
    feats = [np.array(jnp.asarray(f).astype(jnp.bfloat16).astype(jnp.float32))
             for f in feats]

    def f(fs):
        pb, pm = jax_roi_align_train(
            [x.astype(jnp.bfloat16) for x in fs], jnp.asarray(rois),
            jnp.asarray(levels), n_pos, (7, 7), (14, 14), scales,
            bwd_scatter="pallas", acc_dtype=acc)
        return _objective(pb, pm, jnp.cos), (pb, pm)

    (_, (jpb, jpm)), jgrads = jax.value_and_grad(f, has_aux=True)(
        [jnp.asarray(x) for x in feats])
    fs = [torch.from_numpy(x).bfloat16().requires_grad_() for x in feats]
    pb, pm = tra.multilevel_roi_align_train(
        fs, torch.from_numpy(rois), torch.from_numpy(levels), n_pos, (7, 7),
        (14, 14), scales, acc_dtype=getattr(torch, acc))
    assert pb.dtype == pm.dtype == torch.float32
    _objective(pb, pm, torch.cos).backward()
    for got, want in ((pb, jpb), (pm, jpm)):
        want = np.asarray(want)
        err = float(np.abs(got.detach().numpy() - want).max())
        assert err <= 1e-2 * float(np.abs(want).max()), err
    for x, jg in zip(fs, jgrads):
        assert x.grad.dtype == torch.bfloat16
        jg = np.asarray(jg)
        scale = float(np.abs(jg).max())
        assert scale > 0
        err = np.abs(x.grad.float().numpy() - jg)
        assert float(err.max()) <= 3e-2 * scale, (float(err.max()), scale)
        assert float(err.mean()) <= 3e-3 * scale


def test_train_pair_unfolded_geometry_matches_jax():
    """A level width not divisible by 8: fold 1, square 20×20 windows."""
    case = _pair_case(np.random.RandomState(1), [(32, 40), (13, 20)],
                      (0.25, 0.125), c=8)
    (pb, pm), grads = _port_pair(case)
    (jpb, jpm), jgrads = _jax_pair(case, "xla")
    np.testing.assert_allclose(pb, jpb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pm, jpm, rtol=1e-5, atol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, rtol=1e-3, atol=1e-4)


def test_train_pair_window_past_the_buffers_end():
    """A P6 ROI at the bottom-right of the last image: its window runs past
    the end of the flat pyramid. The forward reads zero there and the
    backward drops those rows; JAX clamps the row index instead, onto rows
    that carry zero weight, so both agree, and both equal the gather form."""
    rng = np.random.RandomState(2)
    shapes, scales = [(32, 32), (16, 16), (13, 16)], (0.25, 0.125, 0.0625)
    rois = np.array([[[150.0, 200.0, 208.0, 256.0], [10.0, 20.0, 60.0, 90.0]],
                     [[120.0, 130.0, 208.0, 256.0], [100.0, 160.0, 208.0, 250.0]]],
                    np.float32)
    levels = np.array([[2, 0], [2, 2]], np.int32)
    case = _pair_case(rng, shapes, scales, c=16, n_pos=1, rois=rois, levels=levels)
    feats = case[0]
    s_rows = sum(2 * h * w for h, w in shapes)
    fs = [torch.from_numpy(x) for x in feats]
    row_ids = tra.pair_geometry(
        *tra._level_layout(fs)[::2], torch.from_numpy(rois),
        torch.from_numpy(levels), 1, (7, 7), (14, 14), scales)[0]
    assert int((row_ids[:, -1] + 32 > s_rows).sum()) >= 2  # past the end

    (pb, pm), grads = _port_pair(case)
    (jpb, jpm), jgrads = _jax_pair(case, "xla")
    np.testing.assert_allclose(pb, jpb, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pm, jpm, rtol=1e-5, atol=1e-5)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g, jg, rtol=1e-3, atol=1e-4)
    assert float(np.abs(grads[2][1]).max()) > 0  # the last image's P6 got gradient

    # and against the pointwise gather form with autograd's own backward
    fg = [torch.from_numpy(x).requires_grad_() for x in feats]
    bi = torch.arange(2, dtype=torch.int32)
    gb = tra.roi_align_gather(fg, torch.from_numpy(rois.reshape(4, 4)),
                              bi.repeat_interleave(2),
                              torch.from_numpy(levels.reshape(4)), (7, 7), scales)
    gm = tra.roi_align_gather(fg, torch.from_numpy(rois[:, 0]), bi,
                              torch.from_numpy(levels[:, 0]), (14, 14), scales)
    np.testing.assert_allclose(pb, gb.detach().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pm, gm.detach().numpy(), rtol=1e-5, atol=1e-5)
    _objective(gb, gm, torch.cos).backward()
    for g, f in zip(grads, fg):
        np.testing.assert_allclose(g, f.grad.numpy(), rtol=1e-3, atol=1e-4)


def test_train_pair_gives_no_gradient_to_geometry_and_unused_levels():
    rng = np.random.RandomState(3)
    case = _pair_case(rng, [(32, 40), (16, 24)], (0.25, 0.125), c=8)
    feats, rois, levels, n_pos, scales = case
    levels = np.zeros_like(levels)  # every ROI on level 0
    fs = [torch.from_numpy(x).requires_grad_() for x in feats]
    r = torch.from_numpy(rois).requires_grad_()
    pb, pm = tra.multilevel_roi_align_train(
        fs, r, torch.from_numpy(levels), n_pos, (7, 7), (14, 14), scales)
    (pb.sum() + pm.sum()).backward()
    assert r.grad is None
    assert float(fs[0].grad.abs().max()) > 0
    assert float(fs[1].grad.abs().max()) == 0.0


def test_feature_gradients_are_views_of_the_scatter_output():
    """The backward returns ONE (S, C) buffer; autograd hands each level its
    rows as a view of it, in the NHWC layout the features came in: no
    per-level copy of the gradient is made."""
    rng = np.random.RandomState(4)
    feats, rois, levels, n_pos, scales = _pair_case(
        rng, [(32, 40), (16, 24), (8, 16)], (0.25, 0.125, 0.0625), c=8)
    leaves = [torch.from_numpy(x).requires_grad_() for x in feats]
    fs = [x * 1.0 for x in leaves]  # non-leaf, like the FPN's outputs
    seen = []
    for f in fs:
        f.register_hook(lambda g: seen.append(
            (g.untyped_storage().data_ptr(), g.is_contiguous(), tuple(g.shape))))
    pb, pm = tra.multilevel_roi_align_train(
        fs, torch.from_numpy(rois), torch.from_numpy(levels), n_pos, (7, 7),
        (14, 14), scales)
    (pb.sum() + pm.sum()).backward()
    assert len(seen) == 3 and len({ptr for ptr, _, _ in seen}) == 1
    assert all(contiguous for _, contiguous, _ in seen)
    assert sorted(shape for _, _, shape in seen) == sorted(f.shape for f in fs)
