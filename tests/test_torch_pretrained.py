"""Weight import from chainer npz: the port's loose loader against the JAX
package's ``load_pretrained`` followed by the weight bridge.

For the FPN (``fpn_mask``) and Darknet (``tiny_test``) backbones (the C4
backbone's in ``tests/test_torch_pretrained_c4.py``), a chainer artifact
written by the in-repo emitter (``emit_model_npz``, chainer's ``save_npz``
layout) in two forms, the full serialized model and a bare ImageNet
``ResNet50Layers`` npz (the FPN model's ResNet keys at the root), is loaded into one JAX random init by
JAX's ``load_pretrained`` and converted with ``convert_flax_variables``, and
into the port's model holding the same init by ``load_pretrained_npz``.
Every tensor must be equal in bits (the load is data movement), and both
must report the same parameter and statistic counts. The ImageNet form
loads the ResNet backbone only (none of Darknet's), and a full npz of
another class count raises on the shape mismatch. The train CLI's ``--pretrained-npz`` loads the same tensors (one step at
learning rate 0). The shared init is the port's random init exported into
the JAX model's tree (whose paths come from ``jax.eval_shape`` of its init
at 64×64): the test holds the loaders, not the inits.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from maskrcnn_tpu import config as jcfg  # noqa: E402
from maskrcnn_tpu.models import MaskRCNN as JaxMaskRCNN  # noqa: E402
from maskrcnn_tpu.utils.convert_chainer import load_pretrained  # noqa: E402
from maskrcnn_tpu_torch import config as tcfg  # noqa: E402
from maskrcnn_tpu_torch.cli import train as train_cli  # noqa: E402
from maskrcnn_tpu_torch.models.maskrcnn import MaskRCNN  # noqa: E402
from maskrcnn_tpu_torch.utils.chainer_npz import emit_model_npz  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_chainer import load_pretrained_npz  # noqa: E402
from maskrcnn_tpu_torch.utils.convert_flax import (  # noqa: E402
    convert_flax_variables,
    export_flax_variables,
)

torch.set_num_threads(1)

# preset → (backbone, head, classes) of its emitted artifact
PRESETS = {"fpn_mask": ("fpn", "fpn", 80), "c4_res5": ("c4", "res5", 80),
           "light_head": ("c4", "light", 80), "tiny_test": ("darknet", "fpn", 3)}
CASES = [("fpn_mask", "full"), ("fpn_mask", "imagenet"), ("tiny_test", "full"),
         ("tiny_test", "imagenet")]  # C4's: tests/test_torch_pretrained_c4.py


def _cfg(lib, preset):
    return lib._rep(lib.PRESETS[preset](), train=dict(batch_size=1,
                                                      image_size=(64, 64)))


class Rig:
    """The artifacts and the shared inits, made on first use: per preset
    the full npz, the bare ImageNet ResNet-50 npz, and one random init in
    the port's model and in the JAX model's tree."""

    def __init__(self, root):
        self.root, self.paths, self.inits = root, {}, {}

    def path(self, preset: str, form: str) -> str:
        if form == "imagenet":
            preset = "fpn_mask"
        if preset not in self.paths:
            backbone, head, n = PRESETS[preset]
            npz = emit_model_npz(backbone, head, n_fg_class=n, seed=1)
            full = self.root / f"{preset}.npz"
            np.savez(full, **npz)
            self.paths[preset] = {"full": str(full)}
            if preset == "fpn_mask":
                prefix = "extractor/resnet/"
                imagenet = self.root / "imagenet.npz"
                np.savez(imagenet, **{k[len(prefix):]: v for k, v in npz.items()
                                      if k.startswith(prefix)})
                self.paths[preset]["imagenet"] = str(imagenet)
        return self.paths[preset][form]

    def init(self, preset: str):
        """(the JAX tree, a copy of the port's model), the same weights."""
        if preset not in self.inits:
            jmodel = JaxMaskRCNN(_cfg(jcfg, preset))
            like = jax.eval_shape(lambda key: jmodel.init(
                key, jnp.zeros((1, 64, 64, 3)), method=JaxMaskRCNN.init_forward),
                jax.random.key(0))
            model = MaskRCNN(_cfg(tcfg, preset), device="cpu", seed=0)
            self.inits[preset] = export_flax_variables(model, like), model
        variables, model = self.inits[preset]
        return variables, copy.deepcopy(model)


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    return Rig(tmp_path_factory.mktemp("npz"))


def check_loose_import(rig: Rig, preset: str, form: str, capsys):
    """JAX's ``load_pretrained`` → the bridge, against the port's loose
    import, from the same init: equal tensors and the same report."""
    cfg = _cfg(tcfg, preset)
    backbone, head, _ = PRESETS[preset]
    path = rig.path(preset, form)
    init, model = rig.init(preset)
    capsys.readouterr()
    jax_vars = load_pretrained(init, path, backbone=backbone, head=head,
                               n_mask_convs=cfg.model.n_mask_convs)
    jax_line = capsys.readouterr().out.strip()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n_params, n_stats = load_pretrained_npz(model, path, backbone, head,
                                            cfg.model.n_mask_convs)
    assert capsys.readouterr().out.strip() == jax_line
    want = convert_flax_variables(jax_vars, model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    changed = {k for k in got if not torch.equal(got[k], before[k])}
    if form == "imagenet":
        assert all(k.startswith("extractor.resnet.") for k in changed)
        assert (n_params > 0) == (backbone != "darknet")
    else:
        assert n_params > (100 if backbone != "darknet" else 20)
        assert any(k.startswith("head.") for k in changed)
    assert f"{n_params} param + {n_stats} stat tensors loaded" in jax_line


@pytest.mark.parametrize("preset, form", CASES)
def test_loose_import_matches_jax_load_pretrained(rig, preset, form, capsys):
    check_loose_import(rig, preset, form, capsys)


def test_shape_mismatch_raises(tmp_path):
    cfg = _cfg(tcfg, "tiny_test")
    path = tmp_path / "four_classes.npz"
    np.savez(path, **emit_model_npz("darknet", "fpn", n_fg_class=4))
    model = MaskRCNN(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError, match="converted shape"):
        load_pretrained_npz(model, str(path), "darknet", "fpn")


def test_cli_pretrained_npz(tmp_path, rig, capsys):
    """``--pretrained-npz`` then one step at learning rate 0: the saved
    parameters are the npz's (the Darknet BatchNorms' running statistics
    move in the step; their parameters do not)."""
    path = rig.path("tiny_test", "full")
    train_cli.main(["--preset", "tiny_test", "--device", "cpu", "--iterations", "1",
                    "--lr", "0", "--log-every", "1", "--pretrained-npz", path,
                    "--out", str(tmp_path / "run")])
    assert "initialized full darknet/fpn model from" in capsys.readouterr().out
    cfg = tcfg.tiny_test()
    model = MaskRCNN(cfg, device="cpu", seed=0)
    load_pretrained_npz(model, path, "darknet", "fpn", verbose=False)
    saved = torch.load(tmp_path / "run" / "checkpoints" / "step_00000001.pt",
                       weights_only=False)["model"]
    for k, v in model.named_parameters():
        assert torch.equal(saved[k], v.detach()), k
