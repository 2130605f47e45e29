"""The C4 family's two-pass predict against the JAX package on the CPU.

``light_head`` and ``c4_res5`` at full width (ResNet-50 to res4; the thin
map's 490 channels; res5 and the 2048-wide conv on every ROI) cut to
128×160, batch 2, 3 classes, 256/32 proposals and 16 detections, with one
JAX random init carried into the port by the weight bridge. Every request
goes through ``make_predict_fn`` in both packages: equal
``valid``/``labels``, and boxes, scores and 14×14 masks within 1e-4 of
max(1, max|JAX|). Pass 2 alone is held strictly: JAX's detections through
the port's ``head_mask``. The light head's thin map is computed once per
request in the port and at every pool in JAX: the same values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.eval import make_predict_fn as jax_make_predict_fn  # noqa: E402
from maskrcnn_tpu.models import MaskRCNN as JaxMaskRCNN  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticRequests  # noqa: E402
from maskrcnn_tpu_torch.eval.predict import make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import load_flax_variables  # noqa: E402

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

HW = (128, 160)
B = 2
PRESETS = ["light_head", "c4_res5"]


def _cfg(lib, preset, **model):
    return lib._rep(
        getattr(lib, preset)(), model=dict(n_fg_class=3, **model),
        proposals=dict(n_test_pre_nms=256, n_test_post_nms=32),
        eval=dict(max_detections=16),
        train=dict(batch_size=B, image_size=HW),
    )


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1.0), err


@pytest.fixture(scope="module", params=PRESETS)
def run(request):
    preset = request.param
    cfg = _cfg(jcfg, preset)
    jmodel = JaxMaskRCNN(cfg)
    dummy = jnp.zeros((B, *HW, 3), jnp.float32)
    variables = jax.tree.map(np.asarray, jax.device_get(jax.jit(
        lambda k: jmodel.init(k, dummy, method=JaxMaskRCNN.init_forward))(
            jax.random.key(0))))
    model = MaskRCNN(_cfg(tcfg, preset), device="cpu", seed=0)
    load_flax_variables(model, variables)
    req = SyntheticRequests(_cfg(tcfg, preset), seed=0).batch(0)
    want = jax.tree.map(np.array, jax_make_predict_fn(cfg, jmodel)(
        variables, req.images, req.img_hw, req.scale))
    got = make_predict_fn(_cfg(tcfg, preset), model)(req.images, req.img_hw,
                                                     req.scale)
    return dict(preset=preset, jmodel=jmodel, variables=variables,
                model=model, req=req, want=want, got=got)


def test_predict_matches_jax(run):
    want, got = run["want"], run["got"]
    assert want.valid.sum() >= 8
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    _close(got.boxes, want.boxes)
    _close(got.scores, want.scores)
    assert got.masks.shape == (B, 16, 14, 14) and got.heatmaps is None
    _close(got.masks, want.masks)


def test_pass2_masks_from_jax_detections(run):
    """JAX's detections and features through the port's pass 2: the class
    channel of each detection's mask (for ``c4_res5``, res5 runs again on
    the refined boxes, as in JAX)."""
    jmodel, variables, model, req, want = (run[k] for k in (
        "jmodel", "variables", "model", "req", "want"))
    feats, _, _ = jmodel.apply(variables, jnp.asarray(req.images), False)
    boxes = want.boxes.reshape(-1, 4)
    labels = want.labels.reshape(-1)
    bi = np.repeat(np.arange(B, dtype=np.int32), 16)
    lv = np.zeros(B * 16, np.int32)
    logits = np.asarray(jmodel.apply(
        variables, feats, jnp.asarray(boxes), jnp.asarray(bi), jnp.asarray(lv),
        jnp.asarray(labels), method=JaxMaskRCNN.head_mask))
    assert logits.shape == (B * 16, 14, 14, 3)  # every class; predict selects
    sel = np.take_along_axis(logits, labels[:, None, None, None], 3)[..., 0]
    with torch.no_grad():
        roi_feats = model.roi_features([torch.tensor(np.asarray(f)) for f in feats])
        got = model.head_mask(roi_feats, torch.from_numpy(boxes),
                              torch.from_numpy(bi), torch.from_numpy(lv),
                              torch.from_numpy(labels))
    _close(got, sel)
    if run["preset"] == "light_head":
        assert roi_feats[0].shape == (B, 8, 10, 490)


def test_head_box_locs_follow_the_head(run):
    """Class-agnostic locs for the light head, per class for Res5."""
    model, req = run["model"], run["req"]
    with torch.no_grad():
        feats, _, _ = model(torch.from_numpy(req.images))
        rois = torch.tensor([[10.0, 20.0, 90.0, 120.0], [0.0, 0.0, 60.0, 60.0]])
        locs, scores = model.head_box(model.roi_features(feats), rois,
                                      torch.zeros(2, dtype=torch.int32),
                                      torch.zeros(2, dtype=torch.int32))
    assert locs.shape == (2, 4 if run["preset"] == "light_head" else 16)
    assert scores.shape == (2, 4) and locs.dtype == torch.float32
