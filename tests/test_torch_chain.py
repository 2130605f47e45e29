"""Chained dispatch on the CPU: ``make_train_step(cfg, chain=K)`` and the
train CLI's ``--steps-per-dispatch``.

- ``tiny_test`` (its own 128×160, batch 2) at ``chain=2`` against the JAX
  package's ``make_train_step(chain=2)`` (one ``lax.scan`` over two
  batches) from one JAX random init carried over by the weight bridge, the
  same two synthetic batches and the samplers' draws made along the JAX
  step's own key splits. The Darknet BatchNorms always train, so the RPN's
  shared conv starts at zero in both (``tests/test_torch_darknet_step.py``'s
  recipe). Tolerances: each loss of both steps within ``LOSS_RTOL`` of
  JAX's; each tensor after the two steps within ``PARAM_TOL`` of JAX's,
  relative to max(1, its largest weight). The two frameworks sum float32
  in other orders: the first step's mask loss alone lies 1.5e-5 from JAX's
  and the worst tensor after two steps (a BatchNorm's running variance)
  1.2e-5, so both tolerances are 5e-5.
- The same chained step against two steps of the port from copies of one
  state, bit for bit (one thread, so the CPU's sums run in one order):
  metrics stacked ``(2,)``, parameters, buffers, momentum, ``state.step``
  and the sampler generator.
- ``dispatch_chain``, the JAX CLI's choice of K (``cli/train.py:240-281``),
  case by case.
- ``cli.train --device cpu --steps-per-dispatch 2`` (``tiny_test``, 4
  steps): its log rows equal a K=1 run's, and a run resumed from its step-2
  snapshot ends at the uninterrupted run's checkpoint bit for bit.
- One step makes no host round trip outside NMS's plain version (which
  the card replaces with its kernel): no ``.item()``, ``torch.equal``,
  data-dependent shape or tensor made from host data, under a dispatch
  mode that records every such op.
"""

import json
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import test_torch_darknet_step as dark  # noqa: E402
import test_torch_train_step as base  # noqa: E402
from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.data import SyntheticDetectionData as JaxData  # noqa: E402
from maskrcnn_tpu.train import (  # noqa: E402
    create_train_state as jax_create_train_state,
    init_model,
    make_train_step as jax_make_train_step,
)
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.cli import train as train_cli  # noqa: E402
from maskrcnn_tpu_torch.cli.train import dispatch_chain  # noqa: E402
from maskrcnn_tpu_torch.data.synthetic import SyntheticDetectionData  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN, pyramid_shapes  # noqa: E402
from maskrcnn_tpu_torch.train.state import create_train_state  # noqa: E402
from maskrcnn_tpu_torch.train.step import (  # noqa: E402
    SamplerDraws,
    make_train_step,
    stack_batches,
)
from maskrcnn_tpu_torch.utils.convert_flax import (  # noqa: E402
    convert_flax_variables,
    load_flax_variables,
)

torch.set_num_threads(1)

B = 2
K = 2
LOSS_RTOL = 5e-5
PARAM_TOL = 5e-5
LOSSES = dark.LOSSES


def _cfg(lib):
    return lib._rep(lib.tiny_test(), train=dict(batch_size=B))


@pytest.fixture(scope="module")
def jax_run():
    cfg = _cfg(jcfg)
    jmodel, variables = init_model(cfg, jax.random.key(0))
    variables = dark._quiet_rpn(base._numpy(variables))
    data = JaxData(cfg)
    jbatches = stack_batches([data.batch(i) for i in range(K)])
    jstate = jax_create_train_state(cfg, jax.tree.map(jnp.asarray, variables),
                                    jax.random.key(1))
    key = np.asarray(jax.random.key_data(jstate.key))
    jstate, m = jax_make_train_step(cfg, jmodel, chain=K)(
        jstate, jax.tree.map(jnp.asarray, jbatches))
    jvars = {"params": base._numpy(jstate.params),
             "batch_stats": base._numpy(jstate.batch_stats)}
    return dict(variables=variables, key=key, jvars=jvars,
                jmetrics={k: np.asarray(v) for k, v in m.items()})


def _draws(key, cfg):
    """The JAX step's draws for K steps from ``key``, stacked (K, ...)."""
    (h, w), = pyramid_shapes(cfg, cfg.train.image_size)
    n_cand = cfg.proposals.n_train_post_nms + cfg.train.max_gt
    key, per_step = jax.random.wrap_key_data(key), []
    for _ in range(K):
        draws, key = base.jax_step_draws(key, B, n_cand, h * w * 3)
        per_step.append(draws)
    return SamplerDraws(*(torch.stack(x) for x in zip(*per_step)))


def _port_state(cfg, variables, seed=None):
    model = load_flax_variables(MaskRCNN(cfg, device="cpu", seed=0), variables)
    return create_train_state(cfg, model, seed)


def _batches(cfg):
    data = SyntheticDetectionData(cfg)
    return stack_batches([data.batch(i) for i in range(K)])


def test_chain_matches_jax_chain(jax_run):
    cfg = _cfg(tcfg)
    state = _port_state(cfg, jax_run["variables"])
    metrics = make_train_step(cfg, chain=K)(state, _batches(cfg),
                                            _draws(jax_run["key"], cfg))
    assert state.step == K
    for name in LOSSES:
        got, want = metrics[name].numpy(), jax_run["jmetrics"][name]
        assert got.shape == want.shape == (K,)
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=name)
    want = convert_flax_variables(jax_run["jvars"], state.model)
    got = state.model.state_dict()
    for name, w in want.items():
        w = torch.as_tensor(np.asarray(w))
        scale = max(1.0, float(w.abs().max()))
        assert float((got[name] - w).abs().max()) <= PARAM_TOL * scale, name


def _everything(state):
    out = {f"model.{k}": v.clone() for k, v in state.model.state_dict().items()}
    for i, p in enumerate(state.model.parameters()):
        if p in state.optimizer.state:
            out[f"momentum.{i}"] = state.optimizer.state[p]["momentum_buffer"].clone()
    out["generator"] = state.generator.get_state()
    return out


@pytest.mark.parametrize("draws", ["generator", "given"])
def test_chain_equals_sequential_steps_bit_for_bit(jax_run, draws):
    cfg = _cfg(tcfg)
    batches = _batches(cfg)
    given = _draws(jax_run["key"], cfg) if draws == "given" else None
    one, chained = (_port_state(cfg, jax_run["variables"], seed=3)
                    for _ in range(2))
    step = make_train_step(cfg)
    rows = [step(one, type(batches)(*(None if x is None else x[i] for x in batches)),
                 None if given is None else SamplerDraws(*(x[i] for x in given)))
            for i in range(K)]
    metrics = make_train_step(cfg, chain=K)(chained, batches, given)
    assert chained.step == one.step == K
    for name, v in metrics.items():
        assert v.shape == (K,), name
        assert torch.equal(v, torch.stack([r[name] for r in rows])), name
    want, got = _everything(one), _everything(chained)
    assert want.keys() == got.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    assert chained.optimizer.param_groups[0]["lr"] == one.optimizer.param_groups[0]["lr"]


def test_chain_rejects_a_stack_of_another_length():
    cfg = _cfg(tcfg)
    data = SyntheticDetectionData(cfg)
    batches = stack_batches([data.batch(i) for i in range(3)])
    state = create_train_state(cfg, MaskRCNN(cfg, device="cpu", seed=0))
    with pytest.raises(ValueError, match="3 steps, the chain 2"):
        make_train_step(cfg, chain=K)(state, batches)
    with pytest.raises(ValueError, match="at least 1"):
        make_train_step(cfg, chain=0)


# (steps_per_dispatch, on_cpu, data_parallel, multi_shape, log, snapshot,
#  eval, iterations, start) → (K, note's start or None): JAX's rule
DISPATCH = [
    ((None, False, False, False, 100, 5000, 0, 90000, 0), (20, None)),
    ((None, True, False, False, 100, 5000, 0, 90000, 0), (1, None)),
    ((4, True, False, False, 100, 5000, 0, 90000, 0), (4, None)),
    ((None, False, False, False, 1, 2, 4, 4, 0), (1, None)),
    ((None, False, False, False, 10, 50, 0, 1000, 0), (10, None)),
    ((None, False, False, False, 100, 5000, 1000, 90000, 250), (10, None)),
    ((None, False, False, False, 48, 48, 0, 96, 0), (16, None)),
    ((7, False, False, False, 100, 5000, 0, 90000, 0), (5, "[dispatch] --steps-per-dispatch 7 does not")),
    ((50, False, False, False, 100, 5000, 0, 90000, 0), (50, None)),
    ((200, False, False, False, 100, 5000, 0, 90000, 0), (100, "[dispatch] --steps-per-dispatch 200 does not")),
    ((4, False, True, False, 100, 5000, 0, 90000, 0), (1, "[dispatch] --steps-per-dispatch 4 ignored")),
    ((None, False, True, False, 100, 5000, 0, 90000, 0), (1, None)),
    ((4, False, False, True, 100, 5000, 0, 90000, 0), (1, "[dispatch] --steps-per-dispatch 4 ignored")),
    ((1, False, True, False, 100, 5000, 0, 90000, 0), (1, None)),
    ((4, False, False, False, 100, 5000, 0, 100, 100), (1, "[dispatch] --steps-per-dispatch 4 ignored")),
    ((2, True, False, False, 2, 2, 0, 4, 2), (2, None)),
]


@pytest.mark.parametrize("args, want", DISPATCH)
def test_dispatch_chain_follows_jax(args, want):
    spd, on_cpu, dp, multi, log, snap, ev, iters, start = args
    chain, note = dispatch_chain(
        spd, on_cpu=on_cpu, data_parallel=dp, multi_shape=multi,
        log_every=log, snapshot_every=snap, eval_every=ev, iterations=iters,
        start=start)
    assert chain == want[0]
    if want[1] is None:
        assert note is None
    else:
        assert note.startswith(want[1])
    if chain > 1:  # every boundary falls on a chain's end
        for period in (log, snap, ev or log, iters - start, start or log):
            assert period % chain == 0


CLI = ["--preset", "tiny_test", "--device", "cpu", "--iterations", "4",
       "--log-every", "2", "--snapshot-every", "2"]


def _rows(out):
    with open(out / "log.jsonl") as f:
        return [json.loads(line) for line in f]


def _comparable(row):
    return {k: v for k, v in row.items()
            if k not in ("elapsed_time", "main/prefetch_starved")}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("chain_cli")
    train_cli.main(["--out", str(root / "k1"), "--steps-per-dispatch", "1", *CLI])
    train_cli.main(["--out", str(root / "k2"), "--steps-per-dispatch", "2", *CLI])
    ckpt = root / "resumed" / "checkpoints"
    ckpt.mkdir(parents=True)
    (ckpt / "step_00000002.pt").write_bytes(
        (root / "k2" / "checkpoints" / "step_00000002.pt").read_bytes())
    train_cli.main(["--out", str(root / "resumed"), "--resume",
                    "--steps-per-dispatch", "2", *CLI])
    return root


def test_cli_chain_logs_the_k1_runs_rows(cli_runs, capsys):
    k1, k2 = _rows(cli_runs / "k1"), _rows(cli_runs / "k2")
    assert [r["iteration"] for r in k2] == [1, 2, 4]
    assert [_comparable(r) for r in k2] == [_comparable(r) for r in k1]
    args = json.loads((cli_runs / "k2" / "args.json").read_text())
    assert args["cli"]["steps_per_dispatch"] == 2


def test_cli_chain_resumes_exactly(cli_runs):
    rows = _rows(cli_runs / "resumed")
    assert [r["iteration"] for r in rows] == [4]
    assert _comparable(rows[0]) == _comparable(_rows(cli_runs / "k2")[-1])
    want = torch.load(cli_runs / "k2" / "checkpoints" / "step_00000004.pt",
                      weights_only=False)
    got = torch.load(cli_runs / "resumed" / "checkpoints" / "step_00000004.pt",
                     weights_only=False)
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert torch.equal(got["generator"], want["generator"])
    # and the chained run ends where the K=1 run ends
    k1 = torch.load(cli_runs / "k1" / "checkpoints" / "step_00000004.pt",
                    weights_only=False)
    for k, v in k1["model"].items():
        assert torch.equal(want["model"][k], v), k


def test_cli_refuses_a_chain_below_one(capsys):
    with pytest.raises(SystemExit) as e:
        train_cli.parse_args(["--steps-per-dispatch", "0", "--device", "cpu"])
    assert e.value.code == 2
    assert "at least 1" in capsys.readouterr().err


SYNC_OPS = {"_local_scalar_dense", "nonzero", "equal", "is_nonzero",
            "_unique2", "unique_dim", "unique_consecutive", "masked_select",
            "argwhere", "lift_fresh", "lift_fresh_copy", "repeat_interleave"}


class HostRoundTrips(TorchDispatchMode):
    """Records each op that would make the host wait for the card or copy
    host data to it, with the port's frame that called it; ops called from
    the NMS plain version's module are left out."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name.split("::")[1]
        bool_index = name == "index" and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] or []))
        if name in SYNC_OPS or bool_index:
            frames = [f for f in traceback.extract_stack()
                      if "maskrcnn_tpu_torch" in f.filename]
            where = f"{frames[-1].filename}:{frames[-1].lineno}" if frames else "?"
            if "nms_cuda.py" not in where:
                self.found.append((name, where))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("preset", ["tiny_test", "fpn_mask"])
def test_step_makes_no_host_round_trip(preset):
    cfg = tcfg._rep(tcfg.PRESETS[preset](), train=dict(
        batch_size=2, image_size=(128, 160)), model=dict(n_fg_class=3),
        proposals=dict(n_train_pre_nms=300, n_train_post_nms=64),
        sampler=dict(n_sample=16))
    state = create_train_state(cfg, MaskRCNN(cfg, device="cpu", seed=0))
    step = make_train_step(cfg)
    data = SyntheticDetectionData(cfg)
    step(state, data.batch(0))  # constants made once, before
    batch = type(data.batch(1))(*(None if x is None else torch.as_tensor(x)
                                  for x in data.batch(1)))
    with HostRoundTrips() as mode:
        step(state, batch)
    assert mode.found == []
