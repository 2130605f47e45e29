"""The depth keypoint loader (``data/depth.py``) against the JAX package's on
the CPU, batch for batch and bit for bit.

A seeded manifest from ``data/depth_synthetic.py``: 48×64 frames (the frame
size of JAX's ``tests/test_data.py``), 20 keypoints each, some not recorded
(NaN) and some out of frame. Both loaders read it into
``darknet_keypoint``'s config cut to 128×160 and go through
``iter_from``: without augmentation, with the brightness jitter only, and
with jitter and flips, at two batch sizes. Every :class:`Batch` field
equals JAX's with its dtype. The flip swaps the Kinect skeleton's left and
right rows and mirrors x; the stream resumes at any step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data.depth import DepthKeypointDataset as JaxDepth  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.depth import DepthKeypointDataset  # noqa: E402
from maskrcnn_tpu_torch.data.depth_synthetic import write_depth  # noqa: E402
from maskrcnn_tpu_torch.data.keypoints import DEPTH_KEYPOINT_NAMES  # noqa: E402

torch.set_num_threads(1)

N_FRAMES = 7
FRAME = (48, 64)


def _cfg(lib, batch_size=2):
    return lib._rep(lib.darknet_keypoint(),
                    train=dict(image_size=(128, 160), batch_size=batch_size))


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return write_depth(str(tmp_path_factory.mktemp("depth")), N_FRAMES, FRAME,
                       seed=3)


def _equal(got, want):
    for name, g in got._asdict().items():
        w = getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_manifest_exercises_every_visibility_branch(manifest):
    """The generated frames hold recorded, unrecorded (NaN) and out-of-frame
    keypoints; the loader marks only recorded in-frame ones visible, and
    every box lies inside the resized frame."""
    data = DepthKeypointDataset(_cfg(tcfg), manifest, augment=False)
    assert len(data) == N_FRAMES
    raw = [np.load(f)["keypoints"] for f in data.files]
    assert any(np.isnan(k).any() for k in raw)
    assert any(((k[:, 0] < 0) | (k[:, 0] >= FRAME[1])).any() for k in raw)
    for i in range(N_FRAMES):
        ex = data.get_example(i)
        kp = raw[i]
        inside = (np.isfinite(kp).all(1) & (kp[:, 0] >= 0) & (kp[:, 0] < FRAME[1])
                  & (kp[:, 1] >= 0) & (kp[:, 1] < FRAME[0]))
        np.testing.assert_array_equal(ex["gt_keypoints"][0, :, 2], 2.0 * inside)
        nh, nw = ex["img_hw"]
        box = ex["gt_boxes"][0]
        assert 0 <= box[0] < box[2] <= nh and 0 <= box[1] < box[3] <= nw
        assert ex["gt_valid"].sum() == 1 and ex["image"].dtype == np.float32


@pytest.mark.parametrize("augment, flip", [(False, False), (True, False),
                                          (True, True)])
def test_batches_equal_jax(manifest, augment, flip):
    got = DepthKeypointDataset(_cfg(tcfg), manifest, augment=augment,
                               flip=flip, seed=5)
    want = JaxDepth(_cfg(jcfg), manifest, augment=augment, flip=flip, seed=5)
    for _, g, w in zip(range(5), got.iter_from(0), want.iter_from(0)):
        _equal(g, w)
        assert g.gt_masks is None and g.gt_keypoints.shape == (2, 64, 20, 3)


@pytest.mark.parametrize("batch_size", [2, 3])
def test_iter_from_equals_jax_at_each_batch_size(manifest, batch_size):
    """Steps 4..6 of each stream (the second epoch and past it)."""
    got = DepthKeypointDataset(_cfg(tcfg, batch_size), manifest, seed=9)
    want = JaxDepth(_cfg(jcfg, batch_size), manifest, seed=9)
    for _, g, w in zip(range(3), got.iter_from(4), want.iter_from(4)):
        _equal(g, w)
        assert g.images.shape == (batch_size, 128, 160, 3)


def test_iter_from_resumes_at_its_step(manifest):
    data = DepthKeypointDataset(_cfg(tcfg), manifest, seed=2)
    stream = data.iter_from(0)
    first = [next(stream) for _ in range(6)]
    again = DepthKeypointDataset(_cfg(tcfg), manifest, seed=2).iter_from(3)
    for k in range(3, 6):
        _equal(next(again), first[k])


class _AlwaysFlip(np.random.RandomState):
    def rand(self, *args):
        return 0.0


def test_flip_swaps_the_skeleton_sides(manifest):
    plain = DepthKeypointDataset(_cfg(tcfg), manifest, augment=False)
    flipped = DepthKeypointDataset(_cfg(tcfg), manifest, augment=True, flip=True)
    a = plain.get_example(0)
    b = flipped.get_example(0, _AlwaysFlip(0))
    idx = {n: k for k, n in enumerate(DEPTH_KEYPOINT_NAMES)}
    w0s = FRAME[1] * a["scale"]
    ka, kb = a["gt_keypoints"][0], b["gt_keypoints"][0]
    for left, right in (("HandLeft", "HandRight"), ("KneeLeft", "KneeRight")):
        li, ri = idx[left], idx[right]
        assert kb[li, 2] == ka[ri, 2]
        if ka[ri, 2]:
            np.testing.assert_allclose(kb[li, 1], w0s - ka[ri, 1], atol=1e-3)
            np.testing.assert_allclose(kb[li, 0], ka[ri, 0], atol=1e-3)
    want = JaxDepth(_cfg(jcfg), manifest, augment=True, flip=True).get_example(
        0, _AlwaysFlip(0))
    for k, v in want.items():
        np.testing.assert_array_equal(b[k], v, err_msg=k)
