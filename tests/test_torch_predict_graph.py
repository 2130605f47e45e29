"""The request's capturable body, the part a CUDA graph records, on the CPU.

On the card ``make_predict_fn`` replays a CUDA graph of ``predict.body``
that reads its request from static buffers. A replay repeats the device
work only, so the body must read its inputs through those tensors alone:
no host value, no tensor built from host data, no wait for the device.
Here, at test width (``fpn_mask`` 128×128 b2 with 3 classes, 256/32
proposals and 16 detections; ``tiny_test`` at its own 128×160, b1), with
one JAX random init carried into the port by the weight bridge:

- the body called on ONE set of input buffers, refilled by ``copy_`` with
  seeded requests of different content, content size (``img_hw``) and
  resize scale, equals a fresh ``predict.eager`` call on each in every bit,
  and makes no host round trip;
- the same results equal JAX's ``make_predict_fn`` within the tolerances
  of ``tests/test_torch_predict.py`` (equal ``valid``/``labels``; boxes,
  scores and masks within 1e-4 of max(1, max |JAX|));
- two successive results share no storage; ``decode_boxes`` builds no host
  tensor once its constants exist; on CPU tensors ``predict`` is the body
  with no graph made.
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
from maskrcnn_tpu_torch.eval import predict as predict_mod  # noqa: E402
from maskrcnn_tpu_torch.eval.predict import decode_boxes, make_predict_fn  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import load_flax_variables  # noqa: E402
from test_torch_chain import HostRoundTrips  # noqa: E402

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

TOL = 1e-4  # of max(1, max |JAX|), as tests/test_torch_predict.py holds it
N_REQUESTS = 3
CASES = {  # preset → (image size, batch, image dtype)
    "fpn_mask": ((128, 128), 2, np.float32),
    "tiny_test": ((128, 160), 1, np.uint8),
}


def _cfg(lib, preset):
    hw, b, _ = CASES[preset]
    if preset == "fpn_mask":
        return lib._rep(
            lib.fpn_mask(), model=dict(n_fg_class=3),
            proposals=dict(n_test_pre_nms=256, n_test_post_nms=32),
            eval=dict(max_detections=16), train=dict(batch_size=b, image_size=hw))
    return lib._rep(lib.tiny_test(), train=dict(batch_size=b, image_size=hw))


def _requests(cfg, dtype):
    """Seeded requests: synthetic images cut to a random content size (zero
    beyond it) with a random resize scale, as the loaders pad them."""
    (h, w), out = cfg.train.image_size, []
    for seed in range(N_REQUESTS):
        req = SyntheticRequests(cfg, seed=seed).batch(0)
        rng = np.random.RandomState(100 + seed)
        b = req.images.shape[0]
        img_hw = np.stack([np.floor(h * rng.uniform(0.6, 1.0, b)),
                           np.floor(w * rng.uniform(0.6, 1.0, b))], 1)
        images = req.images.copy()
        for i, (ch, cw) in enumerate(img_hw.astype(int)):
            images[i, ch:] = 0
            images[i, :, cw:] = 0
        if dtype == np.uint8:
            images = np.round(images * 255).astype(np.uint8)
        out.append((images, img_hw.astype(np.float32),
                    rng.uniform(0.5, 1.5, b).astype(np.float32)))
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    """The port's model from JAX's init, the requests, JAX's detections
    and the body's on one set of refilled buffers (the last one under
    :class:`HostRoundTrips`)."""
    preset = request.param
    (h, w), b, dtype = CASES[preset]
    cfg = _cfg(jcfg, preset)
    jmodel = JaxMaskRCNN(cfg)
    dummy = jnp.zeros((b, h, w, 3), jnp.float32)
    init = jax.jit(lambda k: jmodel.init(k, dummy, method=JaxMaskRCNN.init_forward))
    variables = jax.tree.map(np.asarray, jax.device_get(init(jax.random.key(0))))
    pcfg = _cfg(tcfg, preset)
    model = load_flax_variables(MaskRCNN(pcfg, device="cpu", seed=0), variables)
    requests = _requests(pcfg, dtype)
    jax_predict = jax_make_predict_fn(cfg, jmodel)
    want = [jax.tree.map(np.array, jax_predict(variables, *req)) for req in requests]
    predict = make_predict_fn(pcfg, model)
    static = (torch.zeros((b, h, w, 3), dtype=torch.from_numpy(requests[0][0]).dtype),
              torch.zeros((b, 2)), torch.zeros((b,)))
    got = []
    with torch.inference_mode():
        for req in requests:
            for buf, x in zip(static, req):
                buf.copy_(torch.from_numpy(x))
            if len(got) < len(requests) - 1:
                got.append(predict.body(*static))
                continue
            with HostRoundTrips() as mode:
                got.append(predict.body(*static))
    return dict(cfg=pcfg, model=model, predict=predict, requests=requests,
                want=want, got=got, round_trips=mode.found)


def test_body_on_refilled_buffers_equals_fresh_eager_calls(run):
    for req, got in zip(run["requests"], run["got"]):
        fresh = run["predict"].eager(*req)
        for name, g, e in zip(got._fields, got, fresh):
            assert (g is None) == (e is None), name
            if g is not None:
                assert torch.equal(g, e), name
    # the requests differ, and so do their detections
    assert not torch.equal(run["got"][0].boxes, run["got"][1].boxes)


def test_body_equals_jax_predict(run):
    for got, want in zip(run["got"], run["want"]):
        assert want.valid.sum() > 0
        np.testing.assert_array_equal(got.valid.numpy(), want.valid)
        np.testing.assert_array_equal(got.labels.numpy(), want.labels)
        for name in ("boxes", "scores", "masks"):
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert g.shape == w.shape, name
            err = float(np.abs(g - w).max())
            assert err <= TOL * max(1.0, float(np.abs(w).max())), (name, err)


def test_body_makes_no_host_round_trip(run):
    assert run["round_trips"] == []


def test_successive_results_share_no_storage(run):
    predict, (a, b, _) = run["predict"], run["requests"]
    first, second = predict(*a), predict(*b)
    for name, x, y in zip(first._fields, first, second):
        if x is not None:
            assert (x.untyped_storage().data_ptr()
                    != y.untyped_storage().data_ptr()), name
    assert not torch.equal(first.boxes, second.boxes)


def test_decode_boxes_builds_no_host_tensor():
    cfg = _cfg(tcfg, "fpn_mask")
    rng = np.random.RandomState(0)
    r, n_class = 12, cfg.model.n_fg_class + 1
    args = [torch.from_numpy(x) for x in (
        np.sort(rng.uniform(0, 100, (r, 4)), axis=1).astype(np.float32),
        rng.normal(size=(r, 4)).astype(np.float32),
        rng.dirichlet(np.ones(n_class), r).astype(np.float32),
        rng.uniform(size=r) > 0.2, np.array([90.0, 110.0], np.float32))]
    want = decode_boxes(cfg, *args)  # the first call makes the constants
    with HostRoundTrips() as mode:
        got = decode_boxes(cfg, *args)
    assert mode.found == []
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_predict_is_the_body_with_no_graph(run, monkeypatch):
    def no_graph(*args, **kwargs):
        raise AssertionError("a graph on the CPU")

    monkeypatch.setattr(predict_mod, "GraphedPredict", no_graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", no_graph)
    predict = make_predict_fn(run["cfg"], run["model"])
    got, want = predict(*run["requests"][0]), run["got"][0]
    for name, g, w in zip(got._fields, got, want):
        if g is not None:
            assert torch.equal(g, w), name
    assert predict.graphs == {}
