"""The frozen work counts against the numbers PERF.md's kernel table gives
at the same shapes, and the model operation counts."""

import pytest

from port_bench import counts
from port_bench.harness import load_json, BENCH
from port_bench.reference import detector


@pytest.mark.parametrize("got, want", [
    (counts.stem_fp_bound_ms(64, 300, 300)[0], 0.22464873),  # B4, SSD-300 bs=64
    (counts.l2norm_bound_ms(64, 38, 38, 512)[0], 0.02824956),  # B3
    (counts.resnet_stem_bound_ms(64, 512, 512)[0], 0.08013295),  # B6
    (counts.bottleneck_forward_bound_ms(64, 512), 1.07773286),  # B7, a forward
    (counts.pool_bwd_step_bound_ms(32), 0.46673125),  # B5, a step
], ids=["B4", "B3", "B6", "B7", "B5"])
def test_kernel_bounds_match_perf_table(got, want):
    assert got == pytest.approx(want, abs=5e-9)


def test_bounds_say_what_bounds_them():
    assert counts.stem_fp_bound_ms(64, 300, 300)[1] == "operations"
    assert counts.l2norm_bound_ms(64, 38, 38, 512)[1] == "bytes"
    assert counts.resnet_stem_bound_ms(64, 512, 512)[1] == "bytes"


def test_nms_bound_at_the_tables_shape():
    # 1280 rows of 512 columns, every row emitting its 100 survivors.
    ms, by = counts.nms_bound_ms(1280 * 100, 1280, 512, 100)
    assert by == "operations"
    assert ms == pytest.approx(12 * 512 * 128000 / counts.F32_OPS_PER_S * 1e3
                               + 6 * 1280 * 512 / counts.F32_OPS_PER_S * 1e3)


@pytest.mark.parametrize("config, giga", [("ssd300_vgg16_voc", 31.323757568),
                                          ("retinanet_fpn_coco", 61.023076352)])
def test_model_multiply_adds(config, giga):
    arch = load_json(BENCH / "configs" / f"{config}.json")["resolved"]
    assert detector.macs_per_image(arch) == int(round(giga * 1e9))
