"""Every generator of inputs is a function of the seed alone."""

import pytest
import torch

from port_bench import harness, scenes
from port_bench.drivers import common
from port_bench.weights import derive, make_weights

BIG = 2 ** 33 + 12345


def test_derive_takes_large_seeds_and_separates_streams():
    assert derive(BIG, "images") == derive(BIG, "images")
    assert derive(BIG, "images") != derive(BIG, "weights") != derive(BIG + 1, "weights")
    assert 0 <= derive(BIG, "images") < 2 ** 63


def test_scenes_are_deterministic_in_the_seed():
    a = scenes.render(common.generator(BIG, "images", "cpu"), 3, 40, 56)
    b = scenes.render(common.generator(BIG, "images", "cpu"), 3, 40, 56)
    c = scenes.render(common.generator(BIG + 1, "images", "cpu"), 3, 40, 56)
    assert a.dtype == torch.uint8 and a.shape == (3, 40, 56, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("config", ["ssd300_vgg16_voc", "retinanet_fpn_coco"])
def test_weights_are_deterministic_in_the_seed(config):
    spec = harness.load_json(harness.BENCH / "configs" / f"{config}.json")
    arch = {**spec["resolved"], "model": {**spec["resolved"]["model"], "image_size": 64}}
    a = make_weights(arch, spec["weights"], BIG, "cpu")
    b = make_weights(arch, spec["weights"], BIG, "cpu")
    c = make_weights(arch, spec["weights"], BIG + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
