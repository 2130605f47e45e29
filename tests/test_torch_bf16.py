"""``model.dtype="bfloat16"``: the port's predict and train step against the
JAX package on the CPU.

``fpn_mask`` at full width cut to 128×128, batch 2, 3 classes, from one JAX
random init carried into the port by the weight bridge. XLA:CPU and
PyTorch round bf16 convolutions at other places, so the port's bf16 result
is held against JAX's **float32** result: its distance from it must stay
within twice JAX bf16's own distance from JAX float32, plus a floor of
1e-3 of the compared values' size (four bf16 steps of 2^-8 over the ~60
layers would be far more; the floor only keeps a near-zero JAX distance
from failing the test on rounding alone).

- Predict (``eval/predict.py:make_predict_fn``): the RPN outputs, pass 1
  (box branch) on JAX float32's proposals, pass 2 (mask branch) on JAX
  float32's detections, and the end-to-end detections order-free (bf16
  rounding reorders near-tied detections of a random init, in JAX too).
- One train step (``train/step.py:make_train_step``, frozen BN, a bf16
  momentum buffer and the bf16 accumulator of the shared pool's backward)
  from the same weights, batch and sampler draws, with the RPN's shared
  conv zeroed so that the three runs sample the same ROIs (``_quiet_rpn``):
  each loss term, and
  the parameter update as a share of JAX float32's largest update.

At 128×128 the P5/P6 widths (4, 2) do not divide by 8, so JAX's fused
backward falls back to its XLA scatter, which accumulates in bf16; the
port's region scatter takes ``roi_align_acc`` as configured.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_train_step as base  # noqa: E402
from test_torch_trainable_bn import _quiet_rpn  # noqa: E402
from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data import SyntheticDetectionData as JaxData  # noqa: E402
from maskrcnn_tpu.eval import make_predict_fn as jax_make_predict_fn  # noqa: E402
from maskrcnn_tpu.models import MaskRCNN as JaxMaskRCNN  # noqa: E402
from maskrcnn_tpu.models import generate_proposals as jax_proposals  # noqa: E402
from maskrcnn_tpu.models import anchors_for  # noqa: E402
from maskrcnn_tpu.models.maskrcnn import backbone_geometry, pyramid_shapes  # noqa: E402
from maskrcnn_tpu.train import (  # noqa: E402
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import (  # noqa: E402
    SyntheticDetectionData,
    SyntheticRequests,
)
from maskrcnn_tpu_torch.eval.predict import make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import make_train_step  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import (  # noqa: E402
    convert_flax_variables,
    load_flax_variables,
)

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

HW = (128, 128)
B = 2
FLOOR = 1e-3  # of the compared values' size
BF16 = dict(dtype="bfloat16", roi_align_acc="bfloat16")


def _cfg(lib, **model):
    return lib._rep(
        lib.fpn_mask(), model=dict(n_fg_class=3, **model),
        proposals=dict(n_test_pre_nms=256, n_test_post_nms=32,
                       n_train_pre_nms=256, n_train_post_nms=64),
        sampler=dict(n_sample=32), eval=dict(max_detections=16),
        train=dict(batch_size=B, image_size=HW, momentum_dtype=(
            "bfloat16" if model.get("dtype") == "bfloat16" else None)))


def _dist(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _within(port, jax16, what):
    assert port <= 2 * jax16 + FLOOR, (what, port, jax16)


@pytest.fixture(scope="module")
def weights():
    jmodel = JaxMaskRCNN(_cfg(jcfg))
    dummy = jnp.zeros((B, *HW, 3), jnp.float32)
    init = jax.jit(lambda k: jmodel.init(k, dummy,
                                         method=JaxMaskRCNN.init_forward))
    return jax.tree.map(np.array, jax.device_get(init(jax.random.key(0))))


@pytest.fixture(scope="module")
def predict_run(weights):
    """JAX float32, JAX bf16 and the port in bf16 on one request."""
    req = SyntheticRequests(_cfg(tcfg), seed=0).batch(0)
    out = {}
    for name, model in (("f32", {}), ("j16", BF16)):
        jm = JaxMaskRCNN(_cfg(jcfg, **model))
        det = jax_make_predict_fn(_cfg(jcfg, **model), jm)(
            weights, req.images, req.img_hw, req.scale)
        out[name] = (jm, jax.tree.map(np.array, det))
    model = load_flax_variables(MaskRCNN(_cfg(tcfg, **BF16), device="cpu"), weights)
    det = make_predict_fn(_cfg(tcfg, **BF16), model)(req.images, req.img_hw,
                                                     req.scale)
    return dict(req=req, model=model, jax=out, port=det)


def test_port_computes_in_bf16(predict_run):
    model = predict_run["model"]
    with torch.no_grad():
        features, locs, scores = model(torch.from_numpy(predict_run["req"].images))
    assert all(f.dtype == torch.bfloat16 for f in features)
    assert locs.dtype == scores.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    det = predict_run["port"]
    assert det.boxes.dtype == det.scores.dtype == det.masks.dtype == torch.float32


def test_rpn_outputs_within_the_bf16_criterion(predict_run, weights):
    images = jnp.asarray(predict_run["req"].images)
    (_, jl, js), (_, jl16, js16) = (
        predict_run["jax"][k][0].apply(weights, images, False) for k in ("f32", "j16"))
    with torch.no_grad():
        _, pl, ps = predict_run["model"](torch.from_numpy(predict_run["req"].images))
    for got, want, want16, what in ((pl, jl, jl16, "locs"), (ps, js, js16, "scores")):
        _within(_dist(got.numpy(), want), _dist(want16, want), what)


def _jax_proposals(jm, weights, req):
    cfg = _cfg(jcfg)
    _, locs, scores = jm.apply(weights, jnp.asarray(req.images), False)
    anchors = anchors_for(cfg, pyramid_shapes(cfg, HW), backbone_geometry(cfg)[0])
    return jax.tree.map(np.asarray, jax_proposals(
        locs, scores, jnp.asarray(anchors), jnp.asarray(req.scale),
        jnp.asarray(req.img_hw), n_pre=256, n_post=32, nms_thresh=0.7,
        min_size=16.0, n_levels=5))


def test_pass1_on_the_same_proposals(predict_run, weights):
    """The bf16 backbone, the 7×7 pool on bf16 features and the bf16 box
    branch, on JAX float32's proposals."""
    req = predict_run["req"]
    props = _jax_proposals(predict_run["jax"]["f32"][0], weights, req)
    rois = props.rois.reshape(-1, 4)
    levels = props.levels.reshape(-1)
    bi = np.repeat(np.arange(B, dtype=np.int32), props.rois.shape[1])
    outs = {}
    for k in ("f32", "j16"):
        jm = predict_run["jax"][k][0]
        feats, _, _ = jm.apply(weights, jnp.asarray(req.images), False)
        outs[k] = jm.apply(weights, feats, jnp.asarray(rois), jnp.asarray(bi),
                           jnp.asarray(levels), method=JaxMaskRCNN.head_box)
    model = predict_run["model"]
    with torch.no_grad():
        feats = model.extract(torch.from_numpy(req.images))
        got = model.head_box(feats, torch.from_numpy(rois), torch.from_numpy(bi),
                             torch.from_numpy(levels))
    for i, what in enumerate(("locs", "scores")):
        _within(_dist(got[i].numpy(), outs["f32"][i]),
                _dist(outs["j16"][i], outs["f32"][i]), what)


def test_pass2_on_the_same_detections(predict_run, weights):
    req = predict_run["req"]
    det = predict_run["jax"]["f32"][1]
    d = det.boxes.shape[1]
    boxes, labels = det.boxes.reshape(B * d, 4), det.labels.reshape(B * d)
    bi = np.repeat(np.arange(B, dtype=np.int32), d)
    levels = np.random.RandomState(0).randint(0, 5, B * d).astype(np.int32)
    outs = {}
    for k in ("f32", "j16"):
        jm = predict_run["jax"][k][0]
        feats, _, _ = jm.apply(weights, jnp.asarray(req.images), False)
        outs[k] = jax.nn.sigmoid(jm.apply(
            weights, feats, jnp.asarray(boxes), jnp.asarray(bi), jnp.asarray(levels),
            jnp.asarray(labels), method=JaxMaskRCNN.head_mask))
    model = predict_run["model"]
    with torch.no_grad():
        feats = model.extract(torch.from_numpy(req.images))
        got = torch.sigmoid(model.head_mask(
            feats, torch.from_numpy(boxes), torch.from_numpy(bi),
            torch.from_numpy(levels), torch.from_numpy(labels)))
    _within(_dist(got.numpy(), outs["f32"]), _dist(outs["j16"], outs["f32"]), "masks")


def test_predict_end_to_end_within_the_bf16_criterion(predict_run):
    """End to end, the detections' order among near-tied scores of a random
    init moves with bf16 rounding (in JAX bf16 too), so the check is
    order-free: the same count of valid detections per image, and the
    sorted valid scores within the criterion. Boxes and masks are held
    stage-wise above."""
    (_, want), (_, want16) = predict_run["jax"]["f32"], predict_run["jax"]["j16"]
    got = predict_run["port"]
    assert want.valid.sum() > 4

    def sorted_scores(det):
        valid = np.asarray(det.valid)
        counts = valid.sum(axis=1)
        rows = [np.sort(np.asarray(det.scores)[i][valid[i]]) for i in range(B)]
        return counts, np.concatenate(rows)

    (c, s), (c16, s16), (cp, sp) = map(sorted_scores, (want, want16, got))
    np.testing.assert_array_equal(cp, c)
    np.testing.assert_array_equal(c16, c)
    _within(_dist(sp, s), _dist(s16, s), "sorted scores")


@pytest.fixture(scope="module")
def train_run(weights):
    """One step of JAX float32, JAX bf16 and the port in bf16, from the same
    weights (RPN conv zeroed), batch and draws."""
    variables = _quiet_rpn(jax.tree.map(np.array, weights))
    jbatch = JaxData(_cfg(jcfg)).batch(0)
    runs = {}
    for name, model in (("f32", {}), ("j16", BF16)):
        cfg = _cfg(jcfg, **model)
        jm = JaxMaskRCNN(cfg)
        state = jax_create_train_state(  # the step donates the state
            cfg, jax.tree.map(jnp.asarray, variables), jax.random.key(1))
        state, m = jax_make_train_step(cfg, jm)(state, jax.tree.map(jnp.asarray, jbatch))
        runs[name] = ({k: float(v) for k, v in m.items()},
                      base._numpy(state.params))
    cfg = _cfg(tcfg, **BF16)
    model = load_flax_variables(MaskRCNN(cfg, device="cpu"), variables)
    before = base._snapshot(model)
    n_cand = cfg.proposals.n_train_post_nms + cfg.train.max_gt
    n_anchor = sum(h * w for h, w in ((32, 32), (16, 16), (8, 8), (4, 4), (2, 2))) * 3
    draws, _ = base.jax_step_draws(jax.random.key(1), B, n_cand, n_anchor)
    m = make_train_step(cfg)(create_train_state(cfg, model),
                             SyntheticDetectionData(cfg).batch(0), draws)
    after = base._snapshot(model)
    updates = {}
    for name, (_, params) in runs.items():
        new = convert_flax_variables(
            {"params": params, "batch_stats": variables["batch_stats"]}, model)
        updates[name] = {k: (new[k] - before[k]).numpy() for k in before}
    updates["port"] = {k: (after[k] - before[k]).numpy() for k in before}
    return dict(metrics={"f32": runs["f32"][0], "j16": runs["j16"][0],
                         "port": {k: float(v) for k, v in m.items()}},
                updates=updates)


@pytest.mark.parametrize("name", ["loss", "rpn_loc_loss", "rpn_cls_loss",
                                  "roi_loc_loss", "roi_cls_loss", "mask_loss"])
def test_train_losses_within_the_bf16_criterion(train_run, name):
    m = train_run["metrics"]
    want = m["f32"][name]
    assert np.isfinite(m["port"][name]) and m["port"][name] > 0
    _within(abs(m["port"][name] - want) / want, abs(m["j16"][name] - want) / want, name)


def test_train_update_within_the_bf16_criterion(train_run):
    u = train_run["updates"]
    keys = [k for k in u["f32"] if "running" not in k]
    largest = max(float(np.abs(u["f32"][k]).max()) for k in keys)

    def dist(name):
        return max(float(np.abs(u[name][k] - u["f32"][k]).max()) for k in keys) / largest

    _within(dist("port"), dist("j16"), "update")
    moved = [k for k in keys if float(np.abs(u["port"][k]).max()) > 0]
    assert len(moved) > 0.9 * len(keys)
