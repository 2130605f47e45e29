"""Weight import from chainer npz on the C4 backbone
(``tests/test_torch_pretrained.py``'s checks, split off to keep each file
short): the full ``c4_res5`` npz and the ImageNet ResNet-50 npz into
``light_head`` load the same tensors as JAX's ``load_pretrained`` and the
bridge. A full ``light_head`` npz raises in both packages: the reference
layout's mask convs (``head/conv2``..``conv4``, emitted after
``light_roi_mask_head.py``) are 490 wide, JAX's Light-Head's, which the port
copies, 256 (``ROADMAP.md`` §C).
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_pretrained import (  # noqa: E402
    check_loose_import,
    load_pretrained,
    load_pretrained_npz,
    rig,  # noqa: F401 (the fixture)
)


@pytest.mark.parametrize("preset, form", [("c4_res5", "full"),
                                          ("light_head", "imagenet")])
def test_loose_import_matches_jax_load_pretrained(rig, preset, form, capsys):  # noqa: F811
    check_loose_import(rig, preset, form, capsys)


def test_full_light_head_npz_raises_in_both_packages(rig):  # noqa: F811
    path = rig.path("light_head", "full")
    init, model = rig.init("light_head")
    with pytest.raises(ValueError, match=r"head/conv2/bias: converted shape \(490,\)"):
        load_pretrained(init, path, backbone="c4", head="light", verbose=False)
    with pytest.raises(ValueError, match=r"head/conv2/kernel → head.conv2.weight: "
                                         r"converted shape \(490, 490, 3, 3\)"):
        load_pretrained_npz(model, path, "c4", "light")
