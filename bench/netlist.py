"""A configuration's node list: loading, shapes and seeded weights.

A configuration is data (``configs/<name>.json``): the image shape, the
classes, and an ordered list of nodes, each naming its input edges.

  conv    ``k`` x ``k`` filter to ``out`` channels, ``stride``, ``pad``
          on each side, ``act`` ``relu`` or ``none``; the bias is always
          there (BatchNorm folded into it); ``gain`` scales the drawn
          weights (default 1)
  pool    max pool, ``k`` x ``k`` window, ``stride``, ``pad`` (-inf)
  add     elementwise sum of its inputs, then ``act``
  concat  channel concatenation
  gap     global average pool
  dense   ``out`` features, with a bias

This module imports torch alone: the plain reference and the program's
adapter both read it, and neither side's code reaches the other.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CONFIGS = Path(__file__).resolve().parent / "configs"


def load(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


def out_size(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def shapes(cfg: dict, batch: int = 1, image=None) -> Dict[str, Tuple]:
    """Every edge's shape: ``(N, H, W, C)``, or ``(N, C)`` after GAP."""
    h, w, c = image or cfg["image"]
    out = {"input": (batch, h, w, c)}
    for n in cfg["nodes"]:
        op = n["op"]
        ins = n["in"] if isinstance(n["in"], list) else [n["in"]]
        s = out[ins[0]]
        if op in ("conv", "pool"):
            k, st, p = n["k"], n.get("stride", 1), n.get("pad", 0)
            c_out = n["out"] if op == "conv" else s[3]
            out[n["name"]] = (s[0], out_size(s[1], k, st, p),
                              out_size(s[2], k, st, p), c_out)
        elif op == "add":
            out[n["name"]] = s
        elif op == "concat":
            out[n["name"]] = s[:3] + (sum(out[e][3] for e in ins),)
        elif op == "gap":
            out[n["name"]] = (s[0], s[3])
        elif op == "dense":
            out[n["name"]] = (s[0], n["out"])
        else:
            raise ValueError(f"node {n['name']!r}: unknown op {op!r}")
    return out


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """``(node, weight shape, std)`` for every conv (HWIO) and dense
    (in, out) node, in node order: He-scaled draws times the node's
    ``gain``; a dense head at ``1 / sqrt(fan_in)``."""
    sh = shapes(cfg)
    out = []
    for n in cfg["nodes"]:
        if n["op"] == "conv":
            c_in = sh[n["in"]][3]
            fan_in = n["k"] * n["k"] * c_in
            out.append((n["name"], (n["k"], n["k"], c_in, n["out"]),
                        n.get("gain", 1.0) * math.sqrt(2.0 / fan_in)))
        elif n["op"] == "dense":
            c_in = sh[n["in"]][1]
            out.append((n["name"], (c_in, n["out"]), 1.0 / math.sqrt(c_in)))
    return out


def draw_params(cfg: dict, gen: torch.Generator, device) -> Dict[str, Dict]:
    """Name-keyed fp32 params ``{node: {"w": ..., "b": ...}}`` on
    ``device``, drawn from ``gen`` (a generator of that device) in two
    calls: every weight, then every bias."""
    specs = param_specs(cfg)
    sizes = [math.prod(s) for _, s, _ in specs]
    biases = [s[-1] for _, s, _ in specs]
    flat_w = torch.randn(sum(sizes), generator=gen, device=device)
    flat_b = torch.randn(sum(biases), generator=gen, device=device)
    flat_b.mul_(cfg["init"]["bias_std"])
    params, ow, ob = {}, 0, 0
    for (name, shape, std), n, m in zip(specs, sizes, biases):
        w = flat_w[ow:ow + n].view(shape)
        w.mul_(std)
        params[name] = {"w": w, "b": flat_b[ob:ob + m]}
        ow, ob = ow + n, ob + m
    return params


def draw_images(cfg: dict, gen: torch.Generator, device, count: int,
                image=None) -> torch.Tensor:
    """``count`` NHWC fp32 images of standard normal pixels."""
    return torch.randn((count,) + tuple(image or cfg["image"]),
                       generator=gen, device=device)
