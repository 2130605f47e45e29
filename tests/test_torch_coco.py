"""The port's COCO loader against the JAX package's, on the CPU.

Real-schema COCO directories are written here with cv2 (JPEG images, as the
JAX package's own tests write them): landscape and portrait images;
polygon, compressed-RLE and uncompressed-RLE masks; a crowd annotation;
sparse category ids; a ``person_keypoints`` file with labelled, occluded
and unlabelled keypoints and a person without any. Both loaders read the
same directory, and every ``Batch`` field must be EQUAL, bit for bit:
images, boxes, labels, validity, uint8 mask crops, ``img_hw``, scales and
keypoints, in the single-bucket and the bucketed streams, with flips, at
several seek steps. The decoders (RLE, polygons) are held equal with the
native library and with the numpy/cv2 fallbacks.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data import _native as jax_native  # noqa: E402
from maskrcnn_tpu.data import coco as jax_coco  # noqa: E402
from maskrcnn_tpu.data import keypoints as jax_keypoints  # noqa: E402
from maskrcnn_tpu.eval.export import rle_encode as jax_rle_encode  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data import _native, coco  # noqa: E402
from maskrcnn_tpu_torch.data import keypoints  # noqa: E402
from maskrcnn_tpu_torch.data.coco_synthetic import write_coco  # noqa: E402

torch.set_num_threads(1)

BUCKETS = ((128, 160), (160, 128))


def _counts(mask):
    flat = mask.T.reshape(-1)
    change = np.flatnonzero(flat[1:] != flat[:-1])
    counts = np.diff(np.concatenate([[-1], change, [flat.size - 1]])).tolist()
    return ([0] + counts) if flat[0] else counts


def _write(root, split, images, annotations, categories, kind="instances"):
    (root / "annotations").mkdir(parents=True, exist_ok=True)
    with open(root / "annotations" / f"{kind}_{split}.json", "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, f)


@pytest.fixture(scope="module")
def mini_coco(tmp_path_factory):
    """Five images, landscape and portrait, with noise and coloured shapes;
    one annotation of each mask form, a crowd one, sparse category ids."""
    root = tmp_path_factory.mktemp("mini_coco")
    (root / "val").mkdir()
    rng = np.random.RandomState(0)
    sizes = [(64, 80), (90, 60), (72, 96), (96, 72), (60, 90)]
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        img = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
        name = f"{i:06d}.jpg"
        cv2.imwrite(str(root / "val" / name), img)
        images.append({"id": 100 + 7 * i, "file_name": name, "height": h,
                       "width": w})
        for j in range(3):
            y0, x0 = rng.uniform(0, h / 2), rng.uniform(0, w / 2)
            bh, bw = rng.uniform(8, h / 2), rng.uniform(8, w / 2)
            m = np.zeros((h, w), np.uint8)
            m[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = 1
            m[int(y0):int(y0 + bh // 2), int(x0):int(x0 + bw // 3)] = 0
            form = (i + j) % 3
            if form == 0:
                seg = [[x0, y0, x0 + bw, y0 + 2.5, x0 + bw - 3.2, y0 + bh,
                        x0 + 1.7, y0 + bh - 1.1]]
            elif form == 1:
                seg = jax_rle_encode(m)
            else:
                seg = {"size": [h, w], "counts": _counts(m)}
            anns.append({"id": len(anns) + 1, "image_id": 100 + 7 * i,
                         "category_id": (7, 21, 56)[(i + 2 * j) % 3],
                         "bbox": [x0, y0, bw, bh], "area": bw * bh,
                         "iscrowd": 0, "segmentation": seg})
    anns.append({"id": 999, "image_id": 107, "category_id": 7,
                 "bbox": [0, 0, 10, 10], "area": 100, "iscrowd": 1,
                 "segmentation": {"size": [90, 60], "counts": [90 * 60]}})
    _write(root, "val", images, anns,
           [{"id": 7, "name": "cat"}, {"id": 21, "name": "dog"},
            {"id": 56, "name": "bird"}])
    return str(root)


@pytest.fixture(scope="module")
def kp_coco(tmp_path_factory):
    """A ``person_keypoints`` file: people with all three visibilities, one
    with no keypoints (skipped), one crowd (skipped)."""
    root = tmp_path_factory.mktemp("kp_coco")
    (root / "val").mkdir()
    rng = np.random.RandomState(1)
    images, anns = [], []
    for i, (h, w) in enumerate([(64, 80), (80, 64), (70, 100), (100, 70)]):
        name = f"{i:06d}.jpg"
        cv2.imwrite(str(root / "val" / name),
                    rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        images.append({"id": 1 + i, "file_name": name, "height": h, "width": w})
        for _ in range(2):
            x0, y0 = rng.uniform(0, w / 3), rng.uniform(0, h / 3)
            bw, bh = rng.uniform(10, w / 2), rng.uniform(10, h / 2)
            v = rng.randint(0, 3, 17)
            kx = np.where(v > 0, x0 + rng.uniform(0, bw, 17), 0)
            ky = np.where(v > 0, y0 + rng.uniform(0, bh, 17), 0)
            anns.append({"id": len(anns) + 1, "image_id": 1 + i,
                         "category_id": 1, "bbox": [x0, y0, bw, bh],
                         "area": bw * bh, "iscrowd": 0,
                         "num_keypoints": int((v > 0).sum()),
                         "keypoints": np.stack([kx, ky, v], 1).reshape(-1).tolist()})
    anns.append({"id": 900, "image_id": 1, "category_id": 1,
                 "bbox": [1, 1, 5, 5], "area": 25, "iscrowd": 0,
                 "num_keypoints": 0, "keypoints": [0] * 51})
    anns.append({"id": 901, "image_id": 2, "category_id": 1,
                 "bbox": [1, 1, 5, 5], "area": 25, "iscrowd": 1,
                 "num_keypoints": 3, "keypoints": [2, 2, 2] * 17})
    _write(root, "val", images, anns, [{"id": 1, "name": "person"}],
           kind="person_keypoints")
    return str(root)


def _cfgs(preset="fpn_mask", buckets=None, batch_size=2):
    train = dict(batch_size=batch_size, image_size=(128, 160),
                 image_buckets=buckets)
    return (tcfg._rep(tcfg.PRESETS[preset](), train=train),
            jcfg._rep(jcfg.PRESETS[preset](), train=train))


def _loaders(root, preset="fpn_mask", buckets=None, **kw):
    cfg_t, cfg_j = _cfgs(preset, buckets)
    return (coco.COCODetectionLoader(root, "val", cfg_t, **kw),
            jax_coco.COCODetectionLoader(root, "val", cfg_j, **kw))


def _assert_batches_equal(got, want):
    assert got._fields == want._fields
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_index_and_image_ids_match_jax(mini_coco):
    port, ref = _loaders(mini_coco, flip=False)
    assert port.ids == ref.ids and len(port) == len(ref) == 5
    assert port.index.cat_ids == ref.index.cat_ids == [7, 21, 56]
    assert port.index.cat_to_contiguous == ref.index.cat_to_contiguous
    assert port.index.label_names == ["cat", "dog", "bird"]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("image_size", [(128, 160), (160, 128), (64, 96)])
def test_every_batch_field_equals_jax(mini_coco, flip, image_size):
    port, ref = _loaders(mini_coco, flip=flip, seed=3)
    idx = [0, 1, 2, 3, 4, 1]
    rngs = lambda: [np.random.RandomState(10 + k) for k in idx]  # noqa: E731
    got = port.batch(idx, rngs(), image_size=image_size)
    want = ref.batch(idx, rngs(), image_size=image_size)
    _assert_batches_equal(got, want)
    assert got.gt_masks.dtype == np.uint8 and got.gt_keypoints is None
    assert int(got.gt_valid.sum()) == 18  # the crowd annotation is skipped
    assert got.images.shape == (6, *image_size, 3)


def test_iter_from_is_step_pure_and_equals_jax(mini_coco):
    port, ref = _loaders(mini_coco, seed=5)
    full = port.iter_from(0)
    stream = [next(full) for _ in range(8)]
    for k in (0, 3, 5, 7):  # past one epoch (2 batches of 2 per epoch)
        got = next(port.iter_from(k))
        _assert_batches_equal(got, stream[k])
        _assert_batches_equal(got, next(ref.iter_from(k)))


def test_bucketed_stream_equals_jax_batch_for_batch(mini_coco):
    port, ref = _loaders(mini_coco, buckets=BUCKETS, seed=2)
    for i in range(len(port)):
        assert port.bucket_of(i) == ref.bucket_of(i)
    assert {port.bucket_of(i) for i in range(len(port))} == {0, 1}
    a, b = port.iter_from(0), ref.iter_from(0)
    got = [next(a) for _ in range(6)]
    for g in got:
        _assert_batches_equal(g, next(b))
    assert {g.images.shape[1:3] for g in got} == set(BUCKETS)
    assert port.padding_waste() == ref.padding_waste() > 0
    # a seek replays the grouping
    _assert_batches_equal(next(port.iter_from(4)), got[4])


def test_workers_give_the_same_batches(mini_coco):
    port, _ = _loaders(mini_coco, buckets=BUCKETS, seed=2)
    one, four = port.iter_from(1), port.iter_from(1, n_workers=4)
    for _ in range(3):
        _assert_batches_equal(next(four), next(one))
    four.close()


@pytest.mark.parametrize("flip", [False, True])
def test_keypoint_batches_equal_jax(kp_coco, flip):
    port, ref = _loaders(kp_coco, preset="fpn_keypoint", flip=flip, seed=4)
    assert port.keypoints and ref.keypoints and port.ids == ref.ids
    np.testing.assert_array_equal(port.kp_flip_perm, ref.kp_flip_perm)
    a, b = port.iter_from(0), ref.iter_from(0)
    for _ in range(4):
        got = next(a)
        _assert_batches_equal(got, next(b))
        assert got.gt_masks is None and got.gt_keypoints.shape == (2, 64, 17, 3)
    # both people of image 1 are kept, the keypoint-less one is not
    ex = port.get_example(0, np.random.RandomState(0))
    assert int(ex["gt_valid"].sum()) == 2


def test_flip_permutation_and_names_equal_jax():
    for k in (17, 20, 5):
        names = keypoints.keypoint_names(k)
        assert names == jax_keypoints.keypoint_names(k)
        np.testing.assert_array_equal(keypoints.flip_permutation(names),
                                      jax_keypoints.flip_permutation(names))
    perm = keypoints.flip_permutation(keypoints.COCO_KEYPOINT_NAMES)
    assert (perm[perm] == np.arange(17)).all() and perm[1] == 2


@pytest.fixture(params=["native", "fallback"])
def native(request, monkeypatch):
    if request.param == "fallback":
        monkeypatch.setattr(_native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    elif not (_native.available() and jax_native.available()):
        pytest.skip("native/libcoco_fast.so does not load here")
    return request.param


def test_decoders_equal_jax(native):
    rng = np.random.RandomState(7)
    for h, w in ((29, 31), (64, 80), (1, 5)):
        mask = (rng.rand(h, w) > 0.5).astype(np.uint8)
        for rle in ({"size": [h, w], "counts": _counts(mask)},
                    jax_rle_encode(mask)):
            got = coco.rle_decode(rle)
            np.testing.assert_array_equal(got, jax_coco.rle_decode(rle))
            np.testing.assert_array_equal(got, mask)
    polys = [[5.2, 3.1, 28.9, 4.0, 30.0, 25.5, 8.0, 27.0],
             [40, 40, 60, 42, 50, 60], [1, 1, 2, 2]]
    got = coco.polygons_to_mask(polys, 64, 80)
    np.testing.assert_array_equal(got, jax_coco.polygons_to_mask(polys, 64, 80))
    assert got[10, 15] == 1 and got.sum() > 400


def test_loader_equals_jax_with_either_decoder(mini_coco, native):
    port, ref = _loaders(mini_coco, flip=False)
    _assert_batches_equal(port.batch([0, 1, 2, 3, 4]), ref.batch([0, 1, 2, 3, 4]))


def test_category_filter_equals_jax(mini_coco):
    for names in (["cat"], ["dog", "bird"], ["bird"]):
        port, ref = _loaders(mini_coco, category_filter=names)
        assert port.ids == ref.ids
    port, _ = _loaders(mini_coco, category_filter=["cat"])
    assert 0 < len(port) <= 5
    with pytest.raises(ValueError, match="unknown"):
        _loaders(mini_coco, category_filter=["yeti"])


def test_processes_read_their_own_slice(mini_coco, monkeypatch):
    """Under a process group of 2, rank 1 reads every second image from the
    second on, as the JAX loader's process 1 of 2 does."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    port, ref = _loaders(mini_coco)
    assert port.ids == ref.ids and len(port.ids) == 2


def test_generated_directory_loads_in_both(tmp_path):
    """The port's seeded COCO writer (PNG, all three mask forms, a crowd,
    people with keypoints) reads the same in both loaders."""
    write_coco(str(tmp_path), "val", [(96, 128), (128, 96), (100, 120)], seed=1)
    for preset in ("fpn_mask", "fpn_keypoint"):
        port, ref = _loaders(str(tmp_path), preset=preset, flip=True, seed=1)
        assert len(port) == 3
        _assert_batches_equal(next(port.iter_from(1)), next(ref.iter_from(1)))
