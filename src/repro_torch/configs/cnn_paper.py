"""Forward-propagation convolution configurations from the paper's five CNNs.

The paper (§4, Table 1) draws >600 (config x batch) cells from AlexNet,
GoogleNet, ResNet-50, SqueezeNet and VGG19 — all stride 1, padding
(K-1)/2, square inputs/filters, fp32.  The exact per-layer list lives in
the authors' earlier study [11] which is not in the text, so the lists
below are reconstructed from the public architecture definitions; the
distinct-config counts and filter-size fractions match Table 1 (GoogleNet
within a few configs of the published 42 — noted in EXPERIMENTS.md).

Entries are ``(input_hw, k, num_filters_M, depth_C)`` mirroring the
paper's ``[input size]-[#filters]-[depth]`` labels.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

Conv = Tuple[int, int, int, int]          # (H=W, K, M, C)

BATCH_SIZES = (1, 8, 16, 32, 64, 128, 256)

# AlexNet (original Krizhevsky counts; conv1 11x11/4 excluded: stride 4)
ALEXNET: List[Conv] = [
    (27, 5, 256, 96),
    (13, 3, 384, 256),
    (13, 3, 384, 384),
    (13, 3, 256, 384),
]

# VGG19 (all 3x3 stride 1)
VGG19: List[Conv] = [
    (224, 3, 64, 3), (224, 3, 64, 64),
    (112, 3, 128, 64), (112, 3, 128, 128),
    (56, 3, 256, 128), (56, 3, 256, 256),
    (28, 3, 512, 256), (28, 3, 512, 512),
    (14, 3, 512, 512),
]

# SqueezeNet 1.0 fire modules (squeeze/expand) + conv10
SQUEEZENET: List[Conv] = [
    (55, 1, 16, 96), (55, 1, 64, 16), (55, 3, 64, 16),
    (55, 1, 16, 128),
    (55, 1, 32, 128), (55, 1, 128, 32), (55, 3, 128, 32),
    (27, 1, 32, 256), (27, 1, 128, 32), (27, 3, 128, 32),
    (27, 1, 48, 256), (27, 1, 192, 48), (27, 3, 192, 48),
    (27, 1, 48, 384),
    (27, 1, 64, 384), (27, 1, 256, 64), (27, 3, 256, 64),
    (13, 1, 64, 512), (13, 1, 256, 64), (13, 3, 256, 64),
    (13, 1, 1000, 512),
]

# ResNet-50 stride-1 convs (downsample/stride-2 convs excluded)
RESNET50: List[Conv] = [
    (56, 3, 64, 64), (56, 1, 256, 64), (56, 1, 64, 256),
    (28, 3, 128, 128), (28, 1, 512, 128), (28, 1, 128, 512),
    (14, 3, 256, 256), (14, 1, 1024, 256), (14, 1, 256, 1024),
    (7, 3, 512, 512), (7, 1, 2048, 512), (7, 1, 512, 2048),
]

# GoogLeNet: conv2/conv3 + the nine inception modules
# per module: 1x1 branch, 3x3 reduce, 3x3, 5x5 reduce, 5x5, pool proj
_INCEPTION = [
    # (hw, C_in, n1, r3, n3, r5, n5, pp)
    (28, 192, 64, 96, 128, 16, 32, 32),
    (28, 256, 128, 128, 192, 32, 96, 64),
    (14, 480, 192, 96, 208, 16, 48, 64),
    (14, 512, 160, 112, 224, 24, 64, 64),
    (14, 512, 128, 128, 256, 24, 64, 64),
    (14, 512, 112, 144, 288, 32, 64, 64),
    (14, 528, 256, 160, 320, 32, 128, 128),
    (7, 832, 256, 160, 320, 32, 128, 128),
    (7, 832, 384, 192, 384, 48, 128, 128),
]


def _googlenet() -> List[Conv]:
    out: List[Conv] = [(56, 1, 64, 64), (56, 3, 192, 64)]
    for hw, cin, n1, r3, n3, r5, n5, pp in _INCEPTION:
        out += [
            (hw, 1, n1, cin), (hw, 1, r3, cin), (hw, 3, n3, r3),
            (hw, 1, r5, cin), (hw, 5, n5, r5), (hw, 1, pp, cin),
        ]
    # distinct configs only (paper counts distinct parameterizations)
    seen, ded = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            ded.append(c)
    return ded


GOOGLENET: List[Conv] = _googlenet()

NETWORKS: Dict[str, List[Conv]] = {
    "googlenet": GOOGLENET,
    "squeezenet": SQUEEZENET,
    "alexnet": ALEXNET,
    "resnet50": RESNET50,
    "vgg19": VGG19,
}

# Depthwise stages of MobileNet v1 (3x3, groups == C): outside the
# paper's five networks — the paper has no grouped convs at all — but
# the operator IR plans them end-to-end via feature_group_count, so the
# benchmark/test surface names real configurations here.
GroupedConv = Tuple[int, int, int, int, int]   # (H=W, K, M, C, groups)

MOBILENET_DW: List[GroupedConv] = [
    (112, 3, 32, 32, 32),
    (56, 3, 64, 64, 64),
    (28, 3, 128, 128, 128),
    (14, 3, 256, 256, 256),
    (7, 3, 512, 512, 512),
]

# configurations profiled in the paper's tables 3-5
# label -> (hw, batch, k, M, C)
PROFILED = {
    "t3_A": (7, 1, 1, 256, 832),     # table 3 A (cuConv 2.29x region)
    "t3_B": (14, 1, 1, 1024, 256),   # table 3 B
    "t3_C": (27, 1, 1, 256, 64),     # table 3 C
    "t4_A": (7, 1, 3, 384, 192),     # table 4 A
    "t4_B": (13, 1, 3, 384, 384),    # table 4 B
    "t5_A": (7, 1, 5, 128, 48),      # table 5 A
    "t5_B": (7, 8, 5, 128, 48),      # table 5 B
}


def all_distinct() -> List[Conv]:
    seen, out = set(), []
    for net in NETWORKS.values():
        for c in net:
            if c not in seen:
                seen.add(c)
                out.append(c)
    return out


def filter_size_fractions(net: str) -> Dict[int, float]:
    convs = NETWORKS[net]
    out: Dict[int, float] = {}
    for _, k, _, _ in convs:
        out[k] = out.get(k, 0) + 1
    return {k: v / len(convs) for k, v in sorted(out.items())}
