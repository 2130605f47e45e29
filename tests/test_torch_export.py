"""The port's COCO results export against the JAX package's, on the CPU.

- ``rle_encode`` gives JAX's strings byte for byte, and the port's
  ``rle_decode`` inverts it.
- On a generated COCO directory (PNG images of several sizes, scaled into
  a 128×160 bucket, sparse category ids) and under one JAX init (class
  scores spread ×8, or no detection would clear the threshold):
  - fed the SAME detections (JAX's, through both exporters' predict
    caches), ``export_coco_results`` and ``export_coco_keypoint_results``
    write JAX's JSON: equal entries, ids, boxes, scores and keypoints, and
    equal ``segm`` strings wherever the port's pasted mask (torch) equals
    JAX's (cv2); a pixel may differ only where its probability lies within
    a rounding of 0.5, at most 1 in 10⁵ pasted pixels;
  - each through its own predict: the same entries, image and category
    ids, and every float within 1e-4 plus the unit the JSON rounds it to
    (0.01 for coordinates, 1e-5 for scores, 1e-4 for keypoint scores), since
    a value within 1e-4 of a rounding midpoint may round either way.
- Every ``segm`` decodes, with the port's ``rle_decode``, to the mask the
  port pasted; boxes lie in the original images; category ids are the
  annotation file's.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data import coco as jax_coco  # noqa: E402
from maskrcnn_tpu.eval import export as jax_export  # noqa: E402
from maskrcnn_tpu.eval import make_predict_fn as jax_make_predict_fn  # noqa: E402
from maskrcnn_tpu.models import MaskRCNN as JaxMaskRCNN  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data import coco  # noqa: E402
from maskrcnn_tpu_torch.data.coco_synthetic import CATEGORIES, write_coco  # noqa: E402
from maskrcnn_tpu_torch.eval import export  # noqa: E402
from maskrcnn_tpu_torch.eval.postprocess import paste_masks  # noqa: E402
from maskrcnn_tpu_torch.eval.predict import Detections, make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import load_flax_variables  # noqa: E402

torch.set_num_threads(1)

HW = (128, 160)
B = 2
SIZES = [(96, 128), (128, 96), (100, 120), (90, 120), (120, 90)]
FLIP_SHARE = 1e-5
UNITS = {"bbox": 0.01, "score": 1e-5}


def test_rle_encode_equals_jax():
    rng = np.random.RandomState(0)
    masks = [rng.rand(29, 31) > 0.5, np.zeros((7, 9), bool), np.ones((7, 9), bool),
             np.zeros((0, 5), bool), rng.rand(200, 3) > 0.9]
    masks[0][0, 0] = True  # a first run of zeros of length 0
    big = np.zeros((300, 400), bool)
    big[10:290, 50:350] = True  # runs of more than 5 bits, delta-coded
    masks.append(big)
    for m in masks:
        got, want = export.rle_encode(m), jax_export.rle_encode(m)
        assert got == want
        if m.size:
            np.testing.assert_array_equal(coco.rle_decode(got), m.astype(np.uint8))


def _cfg(lib, preset):
    extra = dict(model=dict(n_fg_class=len(CATEGORIES))) if preset == "fpn_mask" else {}
    return lib._rep(
        lib.PRESETS[preset](),
        proposals=dict(n_test_pre_nms=256, n_test_post_nms=32),
        eval=dict(max_detections=16), train=dict(batch_size=B, image_size=HW),
        **extra)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_coco")
    write_coco(str(root), "val", SIZES, seed=3)
    return str(root)


@pytest.fixture(scope="module", params=["fpn_mask", "fpn_keypoint"])
def setup(request, coco_dir):
    """One JAX init of the preset in both packages, both loaders, and JAX's
    detections of every batch the exporters read."""
    preset = request.param
    jmodel = JaxMaskRCNN(_cfg(jcfg, preset))
    dummy = jnp.zeros((B, *HW, 3), jnp.float32)
    init = jax.jit(lambda k: jmodel.init(k, dummy, method=JaxMaskRCNN.init_forward))
    variables = jax.tree.map(np.array, jax.device_get(init(jax.random.key(4))))
    box = variables["params"]["head"]["box"]
    box["score"]["kernel"] = box["score"]["kernel"] * 8.0
    model = load_flax_variables(MaskRCNN(_cfg(tcfg, preset), device="cpu", seed=0),
                                variables)
    loader = coco.COCODetectionLoader(coco_dir, "val", _cfg(tcfg, preset), flip=False)
    jloader = jax_coco.COCODetectionLoader(coco_dir, "val", _cfg(jcfg, preset),
                                           flip=False)
    jax_predict = jax_make_predict_fn(_cfg(jcfg, preset), jmodel)
    return dict(preset=preset, jmodel=jmodel, variables=variables, model=model,
                loader=loader, jloader=jloader, jax_predict=jax_predict)


def _exports(s, tmp_path, port_predict, jax_predict):
    keypoint = s["preset"] == "fpn_keypoint"
    port_fn = export.export_coco_keypoint_results if keypoint else export.export_coco_results
    jax_fn = (jax_export.export_coco_keypoint_results if keypoint
              else jax_export.export_coco_results)
    n = port_fn(_cfg(tcfg, s["preset"]), s["model"], s["loader"],
                str(tmp_path / "port.json"), predict_cache={HW: port_predict})
    m = jax_fn(_cfg(jcfg, s["preset"]), s["jmodel"], s["variables"], s["jloader"],
               str(tmp_path / "jax.json"), predict_cache={HW: jax_predict})
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert n == len(got) and m == len(want)
    return got, want


def _check_against_the_images(s, got):
    """Original coordinates, the file's category ids, segm decodable."""
    info = {im["id"]: im for im in s["loader"].index.images.values()}
    keypoint = s["preset"] == "fpn_keypoint"
    assert {e["image_id"] for e in got} == set(info)
    for e in got:
        im = info[e["image_id"]]
        # boxes are clipped to the resized extent, round(side · scale),
        # which can lie up to half a resized pixel past the original side
        x, y, w, h = e["bbox"]
        assert -0.01 <= x and x + w <= im["width"] + 0.5, e["bbox"]
        assert -0.01 <= y and y + h <= im["height"] + 0.5, e["bbox"]
        if keypoint:
            assert e["category_id"] == 1 and len(e["keypoints"]) == 17 * 3
        else:
            assert e["category_id"] in CATEGORIES
            assert e["segmentation"]["size"] == [im["height"], im["width"]]
    # some image was scaled into the bucket, so "original" is tested
    assert any(float(s["loader"].get_example(i, image_size=HW)["scale"]) != 1.0
               for i in range(len(s["loader"])))


def test_export_of_the_same_detections_equals_jax(setup, tmp_path):
    s = setup
    recorded = []

    def jax_predict(variables, images, img_hw, scale):
        det = jax.tree.map(np.asarray, s["jax_predict"](variables, images, img_hw,
                                                        scale))
        recorded.append(det)
        return det

    replay = iter(recorded)

    def port_predict(images, img_hw, scale):
        return Detections(*(None if v is None else torch.from_numpy(np.array(v))
                            for v in next(replay)))

    # JAX's exporter runs first and records its detections for the port's
    keypoint = s["preset"] == "fpn_keypoint"
    m = (jax_export.export_coco_keypoint_results if keypoint
         else jax_export.export_coco_results)(
        _cfg(jcfg, s["preset"]), s["jmodel"], s["variables"], s["jloader"],
        str(tmp_path / "jax.json"), predict_cache={HW: jax_predict})
    port_fn = export.export_coco_keypoint_results if keypoint else export.export_coco_results
    n = port_fn(_cfg(tcfg, s["preset"]), s["model"], s["loader"],
                str(tmp_path / "port.json"), predict_cache={HW: port_predict})
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert n == m == len(want) >= 3 * len(SIZES)
    flipped = pasted = 0
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        gs, ws = g.pop("segmentation", None), w.pop("segmentation", None)
        assert g == w
        if gs != ws:
            a, b = coco.rle_decode(gs), coco.rle_decode(ws)
            flipped += int((a != b).sum())
        if ws is not None:
            pasted += int(np.prod(ws["size"]))
    assert flipped <= FLIP_SHARE * max(pasted, 1), (flipped, pasted)
    _check_against_the_images(s, got)


def test_export_end_to_end_matches_jax(setup, tmp_path):
    s = setup
    got, want = _exports(s, tmp_path,
                         make_predict_fn(_cfg(tcfg, s["preset"]), s["model"]),
                         s["jax_predict"])
    assert len(got) == len(want) >= 3 * len(SIZES)
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        assert abs(g["score"] - w["score"]) <= 1e-4 + UNITS["score"]
        for a, b in zip(g["bbox"], w["bbox"]):
            assert abs(a - b) <= 1e-4 + UNITS["bbox"], (g["bbox"], w["bbox"])
        if "keypoints" in w:
            for i, (a, b) in enumerate(zip(g["keypoints"], w["keypoints"])):
                unit = 1e-4 if i % 3 == 2 else UNITS["bbox"]
                assert abs(a - b) <= 1e-4 + unit, (i, a, b)
    _check_against_the_images(s, got)


@pytest.mark.parametrize("setup", ["fpn_mask"], indirect=True)
def test_segm_decodes_to_the_pasted_mask(setup, tmp_path):
    s = setup
    loader = s["loader"]
    batch = loader.batch([0, 1])
    det = make_predict_fn(_cfg(tcfg, "fpn_mask"), s["model"])(
        batch.images, batch.img_hw, batch.scale)
    n = export.export_coco_results(_cfg(tcfg, "fpn_mask"), s["model"], loader,
                                   str(tmp_path / "r.json"), n_images=1)
    got = json.loads((tmp_path / "r.json").read_text())
    assert n == len(got) == int(det.valid[0].sum()) > 0
    im = loader.index.images[loader.ids[0]]
    pasted = paste_masks(det.boxes[0] / float(batch.scale[0]), det.masks[0],
                         det.valid[0], (im["height"], im["width"]))
    for e, m in zip(got, pasted):
        np.testing.assert_array_equal(coco.rle_decode(e["segmentation"]),
                                      m.numpy().astype(np.uint8))
