"""The benchmark's operation and byte counts against published counts and
the card smoke's own arithmetic."""

from collections import Counter

import pytest

from benchmark import flops
from benchmark.tests.conftest import ROOT


def test_resnet50_forward_matches_the_published_count():
    # torchvision: ResNet-50 at 224 px, 4.09 GMAC (its 1000-way fc
    # included; the embedding head here is smaller)
    macs = flops.resnet50_macs(224, 256)
    assert macs == pytest.approx(4.09e9, rel=0.01)


def test_efficientnet_b3_forward_matches_the_published_count():
    # Tan & Le, table 2: EfficientNet-B3 at 300 px, 1.8 B multiply-adds
    macs = flops.effnet_macs("efficientnet-b3", 300, 256)
    assert macs == pytest.approx(1.8e9, rel=0.03)


def test_training_counts_three_forwards():
    assert flops.train_flops("resnet50", 64, 256) == \
        3 * flops.forward_flops("resnet50", 64, 256)


def _chip_smoke_conv_cost():
    """``conv_cost`` of chip_smoke.py, read from its source without
    importing the script."""
    import ast
    src = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(src)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "conv_cost")
    scope = {}
    exec(compile(ast.Module([fn], []), "chip_smoke.py", "exec"), scope)
    return scope["conv_cost"]


@pytest.mark.parametrize("name", flops.CONV3X3_KERNELS)
@pytest.mark.parametrize("b,s,c", [(1024, 4, 256), (1024, 2, 512),
                                   (1024, 8, 128), (32, 4, 256)])
def test_conv_cost_matches_the_card_smoke(name, b, s, c):
    assert flops.conv_cost(name, b, s, c) == \
        _chip_smoke_conv_cost()(name, b, s, c)


def test_resnet50_step_launches_and_bounds():
    """One flagship step's launches and least times, as PERF.md's kernel
    table gives them (K1 as the dgrad 0.195 ms, K2 0.059, K3 and K4
    0.137)."""
    plan = flops.resnet50_conv3x3_launches(1024, 64)
    assert Counter(n for n, *_ in plan) == {
        "conv3x3_dgrad": 10, "conv3x3_wgrad": 3,
        "conv3x3_small_bn_relu": 7, "conv3x3_wgrad_bn_relu": 7}
    least = Counter()
    for launch in plan:
        least[launch[0]] += flops.least_seconds(*flops.conv_cost(*launch))
    assert least["conv3x3_dgrad"] * 1e3 == pytest.approx(0.195, abs=5e-4)
    assert least["conv3x3_wgrad"] * 1e3 == pytest.approx(0.059, abs=5e-4)
    assert least["conv3x3_small_bn_relu"] * 1e3 == pytest.approx(0.137,
                                                                 abs=5e-4)
    assert least["conv3x3_wgrad_bn_relu"] * 1e3 == pytest.approx(0.137,
                                                                 abs=5e-4)
