"""A configuration's node list: loading, shapes and seeded weights.

A configuration is data (``configs/<name>.json``): the image shape, the
classes, and an ordered list of nodes, each naming its input edges.

  conv    ``k`` x ``k`` filter to ``out`` channels, ``stride``, ``pad``
          on each side, ``groups`` (default 1; the input's channels and
          ``out`` both divisible by it), ``act`` ``none``, ``relu`` or
          ``gelu`` (the exact erf form); the bias is always there
          (BatchNorm folded into it); ``gain`` scales the drawn weights
          (default 1)
  pool    max pool (``kind`` ``max``), ``k`` x ``k`` window, ``stride``,
          ``pad`` (-inf)
  add     elementwise sum of its inputs, then ``act`` ``none`` or
          ``relu``
  concat  channel concatenation
  norm    LayerNorm over the channels of each pixel (the last axis of
          ``(N, H, W, C)``, or of ``(N, C)`` after ``gap``), ``eps``;
          params ``w`` (the scale) and ``b`` (the shift), each ``(C,)``
  gap     global average pool
  dense   ``out`` features, with a bias

``load`` refuses an op, key, ``act`` or pool ``kind`` outside these, and
a ``groups`` that does not divide, naming the node.

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

#: per op, its required keys, then the optional ones
KEYS = {"conv": ({"k", "out", "act"}, {"stride", "pad", "groups", "gain"}),
        "pool": ({"kind", "k"}, {"stride", "pad"}),
        "add": (set(), {"act"}),
        "concat": (set(), set()),
        "norm": ({"eps"}, set()),
        "gap": (set(), set()),
        "dense": ({"out"}, set())}
ACTS = {"conv": ("none", "relu", "gelu"), "add": ("none", "relu")}
POOL_KINDS = ("max",)


def load(name: str) -> dict:
    return validate(json.loads((CONFIGS / f"{name}.json").read_text()))


def _ins(n: dict) -> list:
    return n["in"] if isinstance(n["in"], list) else [n["in"]]


def validate(cfg: dict) -> dict:
    """``cfg`` itself, or ``ValueError`` naming the first node that
    asks for something outside the vocabulary."""
    edges = {"input"}
    for n in cfg["nodes"]:
        name, op = n.get("name"), n.get("op")
        if op not in KEYS:
            raise ValueError(f"node {name!r}: unknown op {op!r}")
        required, optional = KEYS[op]
        required = required | {"op", "name", "in"}
        missing = required - set(n)
        unknown = set(n) - required - optional
        if missing or unknown:
            raise ValueError(f"node {name!r}: {op} "
                             + (f"lacks {sorted(missing)}" if missing
                                else f"has unknown keys {sorted(unknown)}"))
        gone = [e for e in _ins(n) if e not in edges]
        if gone:
            raise ValueError(f"node {name!r}: no edge {gone[0]!r} before it")
        if op in ACTS and n.get("act", "none") not in ACTS[op]:
            raise ValueError(f"node {name!r}: {op} act {n['act']!r} not in "
                             f"{ACTS[op]}")
        if op == "pool" and n["kind"] not in POOL_KINDS:
            raise ValueError(f"node {name!r}: pool kind {n['kind']!r} not "
                             f"in {POOL_KINDS}")
        if op == "norm" and "norm_std" not in cfg["init"]:
            raise ValueError(f"node {name!r}: a norm needs init.norm_std")
        edges.add(name)
    sh = shapes(cfg)
    for n in cfg["nodes"]:
        g = n.get("groups", 1)
        if n["op"] == "conv" and (g < 1 or sh[n["in"]][3] % g
                                  or n["out"] % g):
            raise ValueError(f"node {n['name']!r}: groups {g} must divide "
                             f"both {sh[n['in']][3]} input and "
                             f"{n['out']} output channels")
    return cfg


def out_size(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def shapes(cfg: dict, batch: int = 1, image=None) -> Dict[str, Tuple]:
    """Every edge's shape: ``(N, H, W, C)``, or ``(N, C)`` after GAP."""
    h, w, c = image or cfg["image"]
    out = {"input": (batch, h, w, c)}
    for n in cfg["nodes"]:
        op = n["op"]
        ins = _ins(n)
        s = out[ins[0]]
        if op in ("conv", "pool"):
            k, st, p = n["k"], n.get("stride", 1), n.get("pad", 0)
            c_out = n["out"] if op == "conv" else s[3]
            out[n["name"]] = (s[0], out_size(s[1], k, st, p),
                              out_size(s[2], k, st, p), c_out)
        elif op in ("add", "norm"):
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
    """``(node, weight shape, std)`` for every conv (HWIO, a grouped
    filter ``(k, k, C / groups, out)``), norm ``(C,)`` and dense
    (in, out) node, in node order: He-scaled draws over the filter's
    fan-in times the node's ``gain``; a norm's scale at
    ``init.norm_std`` about 1; a dense head at ``1 / sqrt(fan_in)``."""
    sh = shapes(cfg)
    out = []
    for n in cfg["nodes"]:
        if n["op"] == "conv":
            c_in = sh[n["in"]][3] // n.get("groups", 1)
            fan_in = n["k"] * n["k"] * c_in
            out.append((n["name"], (n["k"], n["k"], c_in, n["out"]),
                        n.get("gain", 1.0) * math.sqrt(2.0 / fan_in)))
        elif n["op"] == "norm":
            out.append((n["name"], (sh[n["in"]][-1],),
                        cfg["init"]["norm_std"]))
        elif n["op"] == "dense":
            c_in = sh[n["in"]][1]
            out.append((n["name"], (c_in, n["out"]), 1.0 / math.sqrt(c_in)))
    return out


def draw_params(cfg: dict, gen: torch.Generator, device) -> Dict[str, Dict]:
    """Name-keyed fp32 params ``{node: {"w": ..., "b": ...}}`` on
    ``device``, drawn from ``gen`` (a generator of that device) in two
    calls: every weight (a norm's scale among them), then every bias
    (a norm's shift among them)."""
    norms = {n["name"] for n in cfg["nodes"] if n["op"] == "norm"}
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
        if name in norms:
            w.add_(1.0)
        params[name] = {"w": w, "b": flat_b[ob:ob + m]}
        ow, ob = ow + n, ob + m
    return params


def draw_images(cfg: dict, gen: torch.Generator, device, count: int,
                image=None) -> torch.Tensor:
    """``count`` NHWC fp32 images of standard normal pixels."""
    return torch.randn((count,) + tuple(image or cfg["image"]),
                       generator=gen, device=device)
