"""The model's FLOPs, counted on the reference with shapes alone, against
the port's own count of a whole step (``maskrcnn_tpu_torch.bench``'s
``step_flops``: 67,558,821,888 for ``tiny_test``, 1434.77 GFLOP for
``darknet_keypoint`` b8 and 2314.45 GFLOP for ``fpn_mask`` b2, whose
region-form pool backward adds matrix products that this count leaves out
with the pools), and the counts the configuration files hold."""

import pytest

from benchmark import flops, spec
from benchmark.reference import config as ref_config


def test_tiny_test_step_equals_the_ports_count():
    assert flops.train_step_flops(ref_config.tiny_test()) == 67_558_821_888


def test_darknet_keypoint_step_equals_the_ports_count():
    assert flops.train_step_flops(ref_config.darknet_keypoint()) == pytest.approx(
        1434.77e9, abs=0.005e9)


def test_fpn_mask_step_is_the_ports_count_less_the_region_products():
    count = flops.train_step_flops(ref_config.fpn_mask())
    # the shared pool's backward products Byᵀ·g·Bx: 2.27 GFLOP of 2314.45
    assert 2314.45e9 - count == pytest.approx(2.27e9, abs=0.01e9)


@pytest.mark.parametrize("name", ["fpn_mask", "darknet_keypoint"])
def test_configuration_files_hold_the_counts(name):
    file = spec.config_file(name)
    cfg = spec.build_config(ref_config, file)
    assert file["model_flops"] == {"train_step": flops.train_step_flops(cfg),
                                   "request": flops.request_flops(cfg)}
