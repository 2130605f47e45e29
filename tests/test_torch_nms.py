"""The NMS kernel's algorithm on the CPU: the mask-and-walk
(``nms_keep_bitmask_plain``: the suppression matrix in 64-bit words, walked
64 boxes at a time, stopping at the ``n_out``-th kept box) and the Jacobi
spec (``nms_keep_plain``) through the port's ``nms_padded``, against the
JAX package's ``nms_padded`` (its Jacobi fixpoint, and its chunked stream
above 4096 boxes), on seeded cases: long suppression chains, tied scores,
invalid slots, N not a multiple of 64, pairs exactly at the threshold,
leading batch dimensions and ``n_out`` reached early. Exact NMS: the
indices and validity must be equal, and the two keep masks equal on the
prefix up to the ``n_out``-th kept box. The kernel itself is held against
its plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu.ops.nms import nms_padded as jax_nms_padded  # noqa: E402
from maskrcnn_tpu_torch.kernels import nms_cuda  # noqa: E402
from maskrcnn_tpu_torch.ops import nms as nms_mod  # noqa: E402

torch.set_num_threads(1)


def _random(rng, n, lead=(), side=400.0, size=(8.0, 120.0)):
    yx = rng.uniform(0, side, lead + (n, 2))
    hw = rng.uniform(*size, lead + (n, 2))
    boxes = np.concatenate([yx, yx + hw], -1).astype(np.float32)
    return boxes, rng.rand(*lead, n).astype(np.float32), np.ones(lead + (n,), bool)


def _chain(rng, n):
    """Each box overlaps the next one above the threshold and the one after
    it below: a suppression chain as deep as N, kept and dropped in turn."""
    y = np.arange(n, dtype=np.float32) * 3.0
    boxes = np.stack([y, np.zeros(n, np.float32), y + 10.0,
                      np.full(n, 10.0, np.float32)], -1)
    scores = np.linspace(1.0, 0.1, n).astype(np.float32)
    return boxes, scores, np.ones(n, bool)


def _at_threshold(rng, n):
    """Pairs whose IoU is exactly 0.5 in float32 (a 10×10 box and its
    10×5 half) beside pairs just above it: only the latter suppress."""
    base = rng.uniform(0, 300, (n // 2, 2)).astype(np.float32).round()
    full = np.concatenate([base, base + 10.0], -1)
    half = np.concatenate([base, base + np.array([10.0, 5.0], np.float32)], -1)
    half[::3, 3] += 0.25  # IoU 0.525
    boxes = np.concatenate([full, half]).astype(np.float32)
    scores = rng.rand(boxes.shape[0]).astype(np.float32)
    return boxes, scores, np.ones(boxes.shape[0], bool)


def case(name):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    if name == "random":
        return (*_random(rng, 300), 0.5, 100)
    if name == "chain":
        return (*_chain(rng, 257), 0.5, 300)
    if name == "ties":
        b, s, v = _random(rng, 200, size=(30.0, 90.0))
        return b, (s * 4).round() / 4, v, 0.3, 200
    if name == "invalid":
        b, s, v = _random(rng, 190)
        return b, s, rng.rand(190) > 0.3, 0.4, 190
    if name == "n_not_64":
        return (*_random(rng, 129, side=150.0), 0.6, 129)
    if name == "threshold":
        return (*_at_threshold(rng, 200), 0.5, 200)
    if name == "batched":
        b, s, v = _random(rng, 150, lead=(3, 2))
        v[1, 0, ::4] = False
        return b, s, v, 0.3, 40
    if name == "n_out_early":
        return (*_random(rng, 500, side=2000.0, size=(4.0, 40.0)), 0.5, 7)
    if name == "chunked":  # above 4096: JAX streams chunks of 2048
        return (*_random(rng, 4500, side=1500.0), 0.7, 2000)
    raise KeyError(name)


CASES = ["random", "chain", "ties", "invalid", "n_not_64", "threshold",
         "batched", "n_out_early", "chunked"]


def jax_reference(boxes, scores, valid, thresh, n_out, algorithm):
    """JAX's nms_padded over the leading dimensions, one problem at a time."""
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    idx, ok = [], []
    for b, s, v in zip(boxes.reshape(-1, n, 4), scores.reshape(-1, n),
                       valid.reshape(-1, n)):
        i, o = jax_nms_padded(jnp.asarray(b), jnp.asarray(s), thresh, n_out,
                              jnp.asarray(v), algorithm=algorithm)
        idx.append(np.asarray(i))
        ok.append(np.asarray(o))
    return (np.stack(idx).reshape(lead + (n_out,)),
            np.stack(ok).reshape(lead + (n_out,)))


def port(boxes, scores, valid, thresh, n_out, keep_fn, monkeypatch):
    monkeypatch.setattr(nms_mod, "nms_greedy", keep_fn)
    idx, ok = nms_mod.nms_padded(torch.from_numpy(boxes),
                                 torch.from_numpy(scores), thresh, n_out,
                                 torch.from_numpy(valid))
    return idx.numpy(), ok.numpy()


@pytest.mark.parametrize("name", CASES)
def test_bitmask_walk_and_jacobi_equal_jax(name, monkeypatch):
    boxes, scores, valid, thresh, n_out = case(name)
    want = jax_reference(boxes, scores, valid, thresh, n_out,
                         "chunked" if scores.shape[-1] > 4096 else "fixpoint")
    assert want[1].any()
    for keep_fn in (nms_cuda.nms_keep_plain, nms_cuda.nms_keep_bitmask_plain):
        got = port(boxes, scores, valid, thresh, n_out, keep_fn, monkeypatch)
        np.testing.assert_array_equal(got[1], want[1], err_msg=keep_fn.__name__)
        np.testing.assert_array_equal(got[0], want[0], err_msg=keep_fn.__name__)


@pytest.mark.parametrize("name", ["random", "chain", "invalid", "threshold",
                                  "n_out_early"])
def test_walk_stops_at_the_n_out_th_kept_box(name):
    """The walk's keep mask is the fixpoint's up to the n_out-th kept box
    and empty after it."""
    boxes, scores, valid, thresh, n_out = case(name)
    order = np.argsort(-np.where(valid, scores, -1e30), kind="stable")
    b = torch.from_numpy(boxes[order])[None]
    v = torch.from_numpy(valid[order])[None]
    full = nms_cuda.nms_keep_plain(b, v, thresh, n_out)
    walk = nms_cuda.nms_keep_bitmask_plain(b, v, thresh, n_out)
    prefix = torch.cumsum(full.long(), -1) <= n_out
    assert torch.equal(walk, full & prefix)
    assert int(walk.sum()) == min(n_out, int(full.sum()))


def test_chain_needs_many_jacobi_sweeps():
    """The chain case is what the kernel's one pass replaces: the Jacobi
    loop needs a sweep per link."""
    boxes, _, valid, thresh, n_out = case("chain")
    keep = nms_cuda.nms_keep_plain(torch.from_numpy(boxes)[None],
                                   torch.from_numpy(valid)[None], thresh, n_out)
    assert keep[0, ::2].all() and not keep[0, 1::2].any()


def test_pack_words_sets_bit_c_of_word_w():
    sup = torch.zeros((1, 130, 130), dtype=torch.bool)
    sup[0, 3, 63] = sup[0, 3, 64] = sup[0, 129, 129] = True
    words = nms_cuda.pack_words(sup)
    assert words.shape == (1, 130, 3)
    assert int(words[0, 3, 0]) == -(2**63)  # bit 63, the sign bit
    assert int(words[0, 3, 1]) == 1 and int(words[0, 129, 2]) == 2
    assert int(words.count_nonzero()) == 3


def test_work_counts_pairs_with_kept_boxes_up_to_the_stop():
    keep = torch.tensor([[True, False, True, True, False, True]])
    # up to the 3rd kept box (index 3): kept before each is 0, 1, 1, 2
    assert nms_cuda.nms_work(keep, 3)["pairs"] == 4
    # no stop: index 4 and 5 add 3 and 3
    work = nms_cuda.nms_work(keep, 10)
    assert work["pairs"] == 10 and work["flops"] == 10 * nms_cuda.IOU_OPS
    assert work["dense_pairs"] == 15 and work["mask_bytes"] == 8 * 64


def test_wrapper_runs_the_plain_version_on_the_cpu():
    boxes, scores, valid, thresh, n_out = case("random")
    before = nms_cuda.nms_greedy.launches
    b = torch.from_numpy(boxes)[None]
    v = torch.from_numpy(valid)[None]
    assert torch.equal(nms_cuda.nms_greedy(b, v, thresh, n_out),
                       nms_cuda.nms_keep_plain(b, v, thresh, n_out))
    assert nms_cuda.nms_greedy.launches == before
