"""The Darknet presets' two-pass predict against the JAX package on the CPU.

``tiny_test`` (the mask head on the one 256-wide level, 3 classes, 256/32
proposals) at its own 128×160, batch 2, and ``darknet_keypoint(20)`` (the
viewer's model: the keypoint head with 2 convs, 20 keypoints on 56²
heatmaps, 50/10 proposals) at its own 256×320, batch 1, each under the
``evaluate`` (score 0.05) and the ``visualize`` (score 0.7) preset. One
JAX random init is carried into the port by the weight bridge, with the
class-score layer scaled by 32 in both (``bench.py:spread_class_scores``)
and, for the one foreground class of ``darknet_keypoint``, its bias raised
by 2, so that detections pass even the 0.7 threshold. Both pool by gather on
the one level (``roi_align="auto"``). Every request goes through
``make_predict_fn`` in both packages: equal ``valid``/``labels``, and
boxes, scores, masks and heatmaps within 1e-3 of max(1, max |JAX|); the
decoded keypoints within 1e-3 of the box size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.eval import make_predict_fn as jax_make_predict_fn  # noqa: E402
from maskrcnn_tpu.eval.postprocess import decode_keypoints as jax_decode  # noqa: E402
from maskrcnn_tpu.train import init_model  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticRequests  # noqa: E402
from maskrcnn_tpu_torch.eval.postprocess import decode_keypoints  # noqa: E402
from maskrcnn_tpu_torch.eval.predict import make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import load_flax_variables  # noqa: E402

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

TOL = 1e-3
SPREAD = 32.0  # the class-score layer's scale: the 0.7 threshold passes
BATCH = {"tiny_test": 2, "darknet_keypoint": 1}


def _cfg(lib, preset, mode):
    base = lib.darknet_keypoint(n_keypoints=20) if preset == "darknet_keypoint" \
        else lib.tiny_test()
    cfg = lib._rep(base, train=dict(batch_size=BATCH[preset]))
    return lib.use_preset(cfg, mode)


def _spread(variables, preset):
    out = jax.tree.map(lambda x: np.array(x), jax.device_get(variables))
    score = out["params"]["head"]["box"]["score"]
    score["kernel"] *= SPREAD
    if preset == "darknet_keypoint":
        score["bias"][1] += 2.0
    return out


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= TOL * max(float(np.abs(want).max()), 1.0), err


@pytest.fixture(scope="module", params=[
    ("tiny_test", "evaluate"), ("tiny_test", "visualize"),
    ("darknet_keypoint", "evaluate"), ("darknet_keypoint", "visualize")],
    ids=lambda p: "-".join(p))
def run(request):
    preset, mode = request.param
    cfg = _cfg(jcfg, preset, mode)
    jmodel, variables = init_model(cfg, jax.random.key(0))
    variables = _spread(variables, preset)
    pcfg = _cfg(tcfg, preset, mode)
    model = load_flax_variables(MaskRCNN(pcfg, device="cpu", seed=0), variables)
    req = SyntheticRequests(pcfg, seed=3).batch(0)
    want = jax.tree.map(np.array, jax_make_predict_fn(cfg, jmodel)(
        variables, req.images, req.img_hw, req.scale))
    got = make_predict_fn(pcfg, model)(req.images, req.img_hw, req.scale)
    return dict(preset=preset, mode=mode, cfg=pcfg, want=want, got=got)


def test_predict_matches_jax(run):
    want, got, cfg = run["want"], run["got"], run["cfg"]
    b, d = BATCH[run["preset"]], cfg.eval.max_detections
    assert want.valid.sum() >= b  # the scaled class scores pass the threshold
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    _close(got.boxes, want.boxes)
    _close(got.scores, want.scores)
    if run["preset"] == "tiny_test":
        assert got.masks.shape == (b, d, 28, 28) and got.heatmaps is None
        _close(got.masks, want.masks)
        return
    assert got.masks is None and got.heatmaps.shape == (b, d, 56, 56, 20)
    assert want.valid.sum() <= cfg.proposals.n_test_post_nms
    _close(got.heatmaps, want.heatmaps)
    for i in range(b):
        valid = want.valid[i]
        ref = jax_decode(want.boxes[i], want.heatmaps[i], valid)
        kps = decode_keypoints(got.boxes[i].numpy(), got.heatmaps[i].numpy(),
                               valid)
        size = (want.boxes[i][valid, 2:] - want.boxes[i][valid, :2]).max(axis=1)
        assert kps.shape == ref.shape == (int(valid.sum()), 20, 3)
        assert float((np.abs(kps[..., :2] - ref[..., :2]).max(axis=(1, 2))
                      / size).max()) <= TOL
        _close(kps[..., 2], ref[..., 2])
