"""The plain reference of a node-list CNN (``bench/netlist.py``).

``F.conv2d`` (grouped where the node says), ``F.max_pool2d``, exact
``F.gelu``, ``F.layer_norm`` over the channels and a matmul in fp32,
NCHW, with TF32 off for both cuDNN and cuBLAS.  It reads the same params
and images the harness hands the program, and derives its own layouts
from them (HWIO filters to OIHW; a norm on a channels-last view).
``operands`` rounds every conv and dense operand before the product,
and nothing else: ``"tf32"`` (10 mantissa bits, to nearest even) is
the control one precision step below fp32, ``"bf16"`` the step below
that.  Products of TF32 operands are exact in fp32, so the TF32 control
computes what a TF32 tensor core does.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


ROUNDING = {None: lambda t: t, "tf32": round_tf32, "bf16": round_bf16}


@contextlib.contextmanager
def exact_fp32():
    mm = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm


ACTIVATIONS = {"none": lambda y: y, "relu": torch.relu,
               "gelu": lambda y: F.gelu(y, approximate="none")}


def activation(n: dict, y: torch.Tensor) -> torch.Tensor:
    act = n.get("act", "none")
    if act not in ACTIVATIONS:
        raise ValueError(f"node {n['name']!r}: act {act!r}")
    return ACTIVATIONS[act](y)


def layer_norm(x: torch.Tensor, p: Dict, eps: float) -> torch.Tensor:
    """LayerNorm over the channels of NCHW ``x`` (a channels-last view),
    or over the last axis of ``(N, C)``."""
    c = (x.shape[1],)
    if x.dim() == 2:
        return F.layer_norm(x, c, p["w"], p["b"], eps)
    return F.layer_norm(x.permute(0, 2, 3, 1), c, p["w"], p["b"],
                        eps).permute(0, 3, 1, 2)


def logits(cfg: dict, params: Dict[str, Dict], images: torch.Tensor,
           operands: Optional[str] = None) -> torch.Tensor:
    """``(N, classes)`` fp32 logits of NHWC ``images``."""
    q = ROUNDING[operands]
    values = {"input": images.float().permute(0, 3, 1, 2)}
    with exact_fp32(), torch.no_grad():
        for n in cfg["nodes"]:
            op, name = n["op"], n["name"]
            ins = n["in"] if isinstance(n["in"], list) else [n["in"]]
            x = values[ins[0]]
            if op == "conv":
                w = params[name]["w"].permute(3, 2, 0, 1)
                y = F.conv2d(q(x), q(w), params[name]["b"],
                             stride=n.get("stride", 1),
                             padding=n.get("pad", 0),
                             groups=n.get("groups", 1))
                y = activation(n, y)
            elif op == "pool":
                if n["kind"] != "max":
                    raise ValueError(f"node {name!r}: pool {n['kind']!r}")
                y = F.max_pool2d(x, n["k"], n.get("stride", 1),
                                 n.get("pad", 0))
            elif op == "add":
                y = x
                for e in ins[1:]:
                    y = y + values[e]
                y = activation(n, y)
            elif op == "concat":
                y = torch.cat([values[e] for e in ins], dim=1)
            elif op == "norm":
                y = layer_norm(x, params[name], n["eps"])
            elif op == "gap":
                y = x.mean(dim=(2, 3))
            elif op == "dense":
                y = q(x) @ q(params[name]["w"]) + params[name]["b"]
            else:
                raise ValueError(f"node {name!r}: unknown op {op!r}")
            values[name] = y
    return values[cfg["nodes"][-1]["name"]]


def logits_in_blocks(cfg: dict, params, images: torch.Tensor, block: int,
                     operands: Optional[str] = None) -> torch.Tensor:
    """``logits`` over ``images`` ``block`` rows at a time, on the host."""
    return torch.cat([logits(cfg, params, images[i:i + block],
                             operands).cpu()
                      for i in range(0, images.shape[0], block)])
