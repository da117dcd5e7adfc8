"""The yardstick of today's configurations, frozen: the counts and the
draws' sizes that every reading of ``resnet50-fp32`` and
``googlenet-fp32`` rests on.  A change to the vocabulary (grouped convs,
norms) that moved any of them would move those cells' readings."""
import math

import pytest

from bench import counts, netlist

#: multiply-adds an image; least conv time of a batch of 64 (s); the
#: weight draw's and the bias draw's sizes
FROZEN = {"resnet50-fp32": (4_089_184_256, 3.437241131882406e-3,
                            25_502_912, 27_560),
          "googlenet-fp32": (1_582_671_872, 1.3615125020946179e-3,
                             6_990_272, 8_280)}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_yardstick_is_frozen(name):
    macs, least, weights, biases = FROZEN[name]
    cfg = netlist.load(name)
    assert counts.macs_per_image(cfg) == macs
    assert counts.least_conv_s(cfg, 64) == pytest.approx(least, rel=1e-12)
    specs = netlist.param_specs(cfg)
    assert sum(math.prod(s) for _, s, _ in specs) == weights
    assert sum(s[-1] for _, s, _ in specs) == biases
