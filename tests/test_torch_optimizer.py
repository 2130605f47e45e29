"""The port's optimizer against the JAX package's (optax) on the CPU.

``train.momentum_dtype="bfloat16"`` keeps the momentum buffer in bf16
(optax ``sgd(..., accumulator_dtype=bfloat16)`` after
``add_decayed_weights``): the port's :class:`MomentumSGD` is held to the JAX
package's ``make_optimizer`` over three steps with an LR decay, on the same
parameters and gradients (numpy, seeded). The stored bf16 buffer must be
bit-equal to optax's after every step; the parameters agree within two
float32 roundings of their size (``p − lr·new`` is rounded once in each, in
another association). With the float32 buffer (``torch.optim.SGD``) the
buffer agrees within one rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.train.state import make_optimizer as jax_make_optimizer  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.train.state import (  # noqa: E402
    MomentumSGD,
    lr_schedule,
    make_optimizer,
)

torch.set_num_threads(1)

SHAPES = [(64, 3, 7, 7), (256,), (1024, 12544), (81,)]
EPS = float(np.finfo(np.float32).eps)


def _cfg(lib, momentum_dtype):
    return lib._rep(lib.fpn_mask(), train=dict(momentum_dtype=momentum_dtype,
                                               lr_decay_every_iters=2))


def _run(momentum_dtype, steps=3):
    rng = np.random.RandomState(0)
    params = [rng.randn(*s).astype(np.float32) * 0.05 for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * 10.0 ** rng.uniform(-4, 0)
              for s in SHAPES] for _ in range(steps)]

    tx = jax_make_optimizer(_cfg(jcfg, momentum_dtype))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    j_params, j_bufs = [], []
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        trace = opt_state[1][0].trace
        j_params.append([np.asarray(p) for p in jp])
        j_bufs.append([np.asarray(t) for t in trace])

    cfg = _cfg(tcfg, momentum_dtype)
    module = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(p.copy()))
                                     for p in params])
    opt = make_optimizer(cfg, module)
    schedule = lr_schedule(cfg)
    t_params, t_bufs = [], []
    for step, g in enumerate(grads):
        for p, x in zip(module, g):
            p.grad = torch.from_numpy(x)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
        t_params.append([p.detach().numpy().copy() for p in module])
        t_bufs.append([opt.state[p]["momentum_buffer"].clone() for p in module])
    return opt, (j_params, j_bufs), (t_params, t_bufs)


def test_bf16_buffer_is_bit_equal_to_optax():
    opt, (j_params, j_bufs), (t_params, t_bufs) = _run("bfloat16")
    assert isinstance(opt, MomentumSGD)
    for step in range(len(j_bufs)):
        for want, got in zip(j_bufs[step], t_bufs[step]):
            assert want.dtype == ml_dtypes.bfloat16 and got.dtype == torch.bfloat16
            bits = got.view(torch.int16).numpy()
            np.testing.assert_array_equal(bits, want.view(np.int16),
                                          err_msg=f"step {step}")
        for want, got in zip(j_params[step], t_params[step]):
            tol = 2 * EPS * float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= tol, step
    # the buffer is really rounded: a float32 buffer would differ
    t_f32 = _run(None)[2][1]
    assert any(not torch.equal(a.float(), b) for a, b in zip(t_bufs[-1], t_f32[-1]))


def test_float32_buffer_matches_optax():
    opt, (j_params, j_bufs), (t_params, t_bufs) = _run(None)
    assert type(opt) is torch.optim.SGD
    for step in range(len(j_bufs)):
        for want, got in zip(j_bufs[step], t_bufs[step]):
            assert got.dtype == torch.float32
            tol = EPS * float(np.abs(want).max())
            assert float(np.abs(got.numpy() - want).max()) <= tol, step
        for want, got in zip(j_params[step], t_params[step]):
            tol = 2 * EPS * float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= tol, step


def test_momentum_dtype_float32_is_the_plain_sgd():
    opt = make_optimizer(_cfg(tcfg, "float32"), torch.nn.Linear(2, 2))
    assert type(opt) is torch.optim.SGD
