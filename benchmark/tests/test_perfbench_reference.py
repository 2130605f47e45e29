"""The reference against the port at a small size on the CPU: each cell
rehearsed end to end (the program's plain paths, the window, the traced
stretches, the comparison) comes out correct, its compared numbers
within their limits."""

import pytest

from benchmark.tests.rehearsal import rehearse


@pytest.mark.parametrize("cell", ["fpn_mask-serve", "darknet_keypoint-serve",
                                  "fpn_mask-train"])
def test_rehearsal_is_correct(cell):
    line = rehearse(cell)
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    for name, row in line["compared"].items():
        assert row["value"] <= row["limit"], (name, row)
    if "serve" in cell:
        assert line["checked"]["detections"] > 0
        assert set(line["metrics"]) == {"request_ms_p50", "setup_s"}
    else:
        assert set(line["metrics"]) == {"train_images_per_s", "setup_s"}


def test_traced_rehearsal_reads_the_cpu_metrics():
    line = rehearse("fpn_mask-train", trace=1)
    assert line["correct"]
    # no card: the device's readers find nothing, and say so by leaving out
    assert "peak_reserved_gib.train" in line["metrics"]
    assert "pool_kernels_roofline.train" not in line["metrics"]
    assert "mfu.train" not in line["metrics"]
