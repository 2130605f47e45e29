"""The ``fpn_mask`` train step under ``roi_align="gather"`` and ``"pallas"``
against the JAX package on the CPU.

Under these forms both packages pool twice, every slot for the box branch
and the positive prefix for the mask branch, instead of the shared window
pair: ``gather`` trains through autograd of the pointwise form in both;
``pallas`` through JAX's Pallas wrapper with its custom VJP and the port's
``_RegionPool`` (forward kernel, then ``Byᵀ·g·Bx`` and the region
scatter; here their plain versions). JAX's Pallas kernel runs in interpret
mode, which shifts a window that runs past the end of the flat pyramid
where the TPU kernel reads zero (``ROADMAP.md`` §C); the JAX side is given
a zero level past its pyramid so that no window is shifted, and gets the
TPU kernel's values.

Settings, draws and tolerances are ``test_torch_train_step.py``'s (128×128,
batch 2, 3 classes, 256/64 proposals, 32 sampled ROIs; losses within 1e-4
relative, updates within 0.5% of the step's largest and 5% of each
tensor's own plus two roundings), for one step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import maskrcnn_tpu.kernels as jax_kernels  # noqa: E402
import test_torch_train_step as base  # noqa: E402
from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data import SyntheticDetectionData as JaxData  # noqa: E402
from maskrcnn_tpu.train import (  # noqa: E402
    create_train_state as jax_create_train_state,
    init_model,
    make_train_step as jax_make_train_step,
)
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.ops import roi_align as tra  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import make_train_step  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import convert_flax_variables  # noqa: E402

torch.set_num_threads(1)
torch.set_default_dtype(torch.float32)

B = base.B
N_ANCHOR = sum(h * w for h, w in ((32, 32), (16, 16), (8, 8), (4, 4), (2, 2))) * 3


def _interpret_reading_zero_past_the_end(pallas):
    def pool(features, rois, bi, lv, out_size, scales, sampling_ratio=2,
             t_span=20, interpret=False):
        b, c = features[0].shape[0], features[0].shape[-1]
        zeros = jnp.zeros((b, 64, 64, c), features[0].dtype)
        return pallas(list(features) + [zeros], rois, bi, lv, out_size,
                      tuple(scales) + (1.0,), sampling_ratio, t_span,
                      interpret=True)
    return pool


@pytest.fixture(scope="module", params=["gather", "pallas"])
def run(request):
    mp = pytest.MonkeyPatch()
    yield _run(request.param, mp)
    mp.undo()


def _run(impl, mp):
    if impl == "pallas":
        mp.setattr(
            jax_kernels, "multilevel_roi_align_pallas",
            _interpret_reading_zero_past_the_end(
                jax_kernels.multilevel_roi_align_pallas))
    cfg = base._cfg(jcfg, model=dict(roi_align=impl))
    jmodel, variables = init_model(cfg, jax.random.key(0))
    variables = base._numpy(variables)
    jbatch = JaxData(cfg).batch(0)
    jstate = jax_create_train_state(cfg, jax.tree.map(jnp.asarray, variables),
                                    jax.random.key(1))
    key = np.asarray(jax.random.key_data(jstate.key))
    jstate, m = jax_make_train_step(cfg, jmodel)(
        jstate, jax.tree.map(jnp.asarray, jbatch))
    jmetrics = {k: float(v) for k, v in m.items()}
    jparams = base._numpy(jstate.params)

    pcfg = base._cfg(tcfg, model=dict(roi_align=impl))
    model = base._port_model(pcfg, variables)
    state = create_train_state(pcfg, model)
    draws, _ = base.jax_step_draws(
        jax.random.wrap_key_data(key), B,
        pcfg.proposals.n_train_post_nms + pcfg.train.max_gt, N_ANCHOR)
    calls = {"pair": 0, "pool": 0}
    pair, pool = tra._RegionPair.apply, tra._RegionPool.apply

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    mp.setattr(tra._RegionPair, "apply", count("pair", pair))
    mp.setattr(tra._RegionPool, "apply", count("pool", pool))
    before = base._snapshot(model)
    metrics = {k: float(v) for k, v in make_train_step(pcfg)(
        state, SyntheticDetectionData(pcfg).batch(0), draws).items()}
    jweights = [convert_flax_variables(
        {"params": p, "batch_stats": variables["batch_stats"]}, model)
        for p in (variables["params"], jparams)]
    return dict(impl=impl, jmetrics=jmetrics, metrics=metrics,
                jweights=jweights, weights=[before, base._snapshot(model)],
                calls=calls)


def test_gather_and_pallas_pools_train_as_in_jax(run):
    """Losses and the first update equal JAX's under the same form; the
    port pooled twice, through the region-scatter backward for
    ``"pallas"`` and through autograd for ``"gather"``."""
    want, got = run["jmetrics"], run["metrics"]
    for name in ("loss", "rpn_loc_loss", "rpn_cls_loss", "roi_loc_loss",
                 "roi_cls_loss", "mask_loss"):
        assert np.isfinite(got[name]) and got[name] > 0, name
        assert abs(got[name] - want[name]) <= base.LOSS_RTOL * abs(want[name]), (
            name, got[name], want[name])
    base._assert_updates_match(run, 0)
    assert run["calls"] == {"pair": 0,
                            "pool": 2 if run["impl"] == "pallas" else 0}
