"""The yardstick's arithmetic: operations, bytes, least times and the
H100's peaks, from a configuration's node list alone.

The work of a conv node is the direct convolution's, whatever executor
runs it: ``2 * N * OH * OW * K * K * (C_in / groups) * C_out`` FLOPs.
A Winograd node does fewer multiplications than that, and so can read a
share of this bound that its own operation count would not give; the
count is the same for every implementation, so a faster executor reads
higher.

A conv node's bytes are its input, weights, bias and output, each once,
in fp32.  Where the conv's one consumer is a pool (which an executor may
fold into the conv) the output counted is the pooled one: the least
that any implementation must write.  A grouped conv's weights are
``K * K * (C_in / groups) * C_out``.

A ``norm`` node counts no FLOPs and no conv bytes: it is none of the
conv nodes, and ``mfu`` counts the convs' and the dense head's FLOPs
alone, as it leaves out pools, adds and activations.
"""
from __future__ import annotations

import re
from typing import Dict, List

from bench import netlist

#: NVIDIA H100 SXM (data sheet, dense): TF32 tensor cores at 495
#: TFLOP/s; fp32-accurate products by 3xTF32 at a third of that, which
#: is how the port's fp32 tensor-core kernels compute
PEAK_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12                    # HBM3 bytes/s
FP32 = 4

#: the port's conv kernels (``csrc/*.cu``), whole names: the device time
#: of the nodes whose executors launch them, and of nothing else (a
#: library's conv kernels, such as cuDNN's ``convolve_*`` or
#: ``winograd*``, run nodes that ``conv_roofline`` leaves out)
PORT_CONV_KERNELS = ("cuconv_fused_kernel", "winograd_fused_kernel",
                     "conv1x1_tc_kernel", "direct_conv_tc_kernel",
                     "stage1_tc_kernel", "stage2_tap_sum_kernel")
PORT_CONV_KERNEL = re.compile(r"\b(?:%s)\b" % "|".join(PORT_CONV_KERNELS))

#: each of those kernels by the launch name an executor gives it
#: (``Executor.kernels``): a node whose executor launches a kernel not
#: here is left out of the rooflines, and so is that kernel's time
KERNEL_OF_LAUNCH = dict(zip(
    ("cuconv_fused", "winograd_fused", "conv1x1_gemm", "direct_conv",
     "stage1_tap_gemm", "stage2_tap_sum"), PORT_CONV_KERNELS))


def is_port_conv_kernel(name: str) -> bool:
    return bool(PORT_CONV_KERNEL.search(name))


def kernel_of(launch: str):
    """A match, for ``Trace.kernel_s``, of the records of the kernel
    that ``launch`` names, by its whole name."""
    return re.compile(r"\b%s\b" % KERNEL_OF_LAUNCH[launch]).search


def conv_nodes(cfg: dict, batch: int, image=None) -> List[Dict]:
    """Per conv node: its FLOPs, least bytes and least time at ``batch``."""
    sh = netlist.shapes(cfg, batch, image)
    consumers: Dict[str, List[dict]] = {}
    for n in cfg["nodes"]:
        for e in (n["in"] if isinstance(n["in"], list) else [n["in"]]):
            consumers.setdefault(e, []).append(n)
    out = []
    for n in cfg["nodes"]:
        if n["op"] != "conv":
            continue
        nb, h, w, c = sh[n["in"]]
        _, oh, ow, m = sh[n["name"]]
        k, cg = n["k"], c // n.get("groups", 1)
        flops = 2 * nb * oh * ow * k * k * cg * m
        written = sh[n["name"]]
        cons = consumers.get(n["name"], [])
        if len(cons) == 1 and cons[0]["op"] == "pool":
            written = sh[cons[0]["name"]]
        nbytes = FP32 * (nb * h * w * c + k * k * cg * m + m
                         + _numel(written))
        out.append({"name": n["name"], "flops": flops, "bytes": nbytes,
                    "least_s": max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)})
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def macs_per_image(cfg: dict, image=None) -> int:
    """Multiply-adds of one image: every conv and the dense head."""
    sh = netlist.shapes(cfg, 1, image)
    total = sum(c["flops"] for c in conv_nodes(cfg, 1, image)) // 2
    for n in cfg["nodes"]:
        if n["op"] == "dense":
            total += sh[n["in"]][1] * n["out"]
    return total


def flops_per_image(cfg: dict, image=None) -> int:
    return 2 * macs_per_image(cfg, image)


def least_conv_s(cfg: dict, batch: int, image=None) -> float:
    """The least time of every conv node of one batch, summed."""
    return sum(c["least_s"] for c in conv_nodes(cfg, batch, image))
