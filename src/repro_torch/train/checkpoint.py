"""Fault-tolerant checkpointing in the JAX package's format.

A checkpoint written by either package restores in the other:
  * atomic: write to ``step_N.tmp/`` then rename to ``step_N/``; a crash
    mid-write never corrupts the latest checkpoint, and the oldest
    beyond ``keep`` are removed after each publish;
  * self-describing: ``manifest.json`` records each array's key, file,
    shape, dtype and a content hash (sha256 prefix of its saved bytes);
    restore verifies them and refuses a missing or extra key, a shape
    mismatch or a corrupt file;
  * the reference's layout: keys are its tree paths
    (``params/segments/0/pos0/ln1/scale``, ``opt/master/...``,
    ``opt/m/...``, ``opt/v/...``, ``step``, ``ef/...``), an LM layer's
    leaves stacked along the leading repeats axis it keeps them in
    (``tree.walk``), so ``params/segments/0/pos0/ln1/scale`` is (R, D);
  * bf16 (and float8_e4m3fn) is stored as its raw bits in a same-width
    unsigned integer array, the logical dtype in the manifest;
  * async: ``save_checkpoint(..., async_=True)`` copies every tensor to
    the host before the writer thread starts, so the train loop may
    update the state in place while the disk write runs;
  * auto-resume: ``latest_step`` finds the newest complete checkpoint;
  * mesh-independent: a DTensor leaf is gathered whole (``full_tensor``,
    on every rank) and rank 0 writes the unsharded layout while the
    other ranks wait at a barrier, so ``restore_checkpoint(...,
    shardings=...)`` places it onto whatever mesh comes up (the
    reference's elastic re-mesh), or onto none.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.convspec import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.tree import fill, key, leaves, unflatten, walk

_SENTINEL = "manifest.json"

# logical dtype -> (torch dtype, the numpy integer type of its bits)
_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8)}
_SIGNED = {np.uint16: torch.int16, np.uint8: torch.uint8}
_TORCH_NAME = {torch.float32: "float32", torch.float64: "float64",
               torch.float16: "float16", torch.int32: "int32",
               torch.int64: "int64", torch.int8: "int8",
               torch.uint8: "uint8", torch.bool: "bool"}


def _to_host(t: torch.Tensor):
    """(numpy array to save, logical dtype name): a copy, never a view of
    the tensor (the caller may update it in place afterwards)."""
    t = shd.whole(t.detach())
    for name, (dt, bits) in _EXOTIC.items():
        if t.dtype == dt:
            raw = t.view(_SIGNED[bits]).to("cpu", copy=True).numpy()
            return raw.view(bits), name
    return t.to("cpu", copy=True).numpy(), _TORCH_NAME[t.dtype]


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")       # keeps a 0-d array 0-d
    if dtype_name in _EXOTIC:
        dt, bits = _EXOTIC[dtype_name]
        raw = torch.from_numpy(arr.view(bits).view(
            np.int16 if bits is np.uint16 else np.uint8))
        return raw.view(dt)
    return torch.from_numpy(arr)


def _flatten_host(tree) -> Dict[str, tuple]:
    """key -> (array in the reference's layout, dtype name)."""
    rows: Dict[str, list] = {}
    stacked = {}
    for path, rep, leaf in walk(tree):
        k = key(path)
        rows.setdefault(k, []).append(_to_host(leaf))
        stacked[k] = rep is not None
    out = {}
    for k, rs in rows.items():
        if stacked[k]:
            out[k] = (np.stack([a for a, _ in rs]), rs[0][1])
        else:
            out[k] = rs[0]
    return out


def _hash(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.tobytes()).hexdigest()[:16]


def save_checkpoint(ckpt_dir, step: int, tree, *, async_=False,
                    keep: int = 3):
    """Write ``tree`` as ``ckpt_dir/step_{step}``; returns its path, or
    with ``async_`` the started writer thread.  A tree of DTensors is a
    collective call: every rank gathers, rank 0 writes, and a sync save
    returns on every rank once the checkpoint is published (an async
    one returns None on the other ranks)."""
    ckpt_dir = Path(ckpt_dir)
    sharded = any(isinstance(t, DTensor) for t in leaves(tree))
    writer = not sharded or dist.get_rank() == 0
    if writer:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
    # device -> host (blocking part; the disk write can be async)
    host = _flatten_host(tree)
    if not writer:
        del host
        if not async_:
            dist.barrier()
        return None

    def write():
        tmp = ckpt_dir / f"step_{step}.tmp"
        final = ckpt_dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "arrays": {}}
        for k, (enc, dtype_name) in host.items():
            fname = hashlib.md5(k.encode()).hexdigest()[:12] + ".npy"
            np.save(tmp / fname, enc)
            manifest["arrays"][k] = {
                "file": fname, "shape": list(enc.shape), "dtype": dtype_name,
                "hash": _hash(enc),
            }
        (tmp / _SENTINEL).write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    if sharded:
        dist.barrier()
    return ckpt_dir / f"step_{step}"


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(latest_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def latest_steps(ckpt_dir) -> list:
    ckpt_dir = Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for d in ckpt_dir.iterdir():
        if d.is_dir() and d.name.startswith("step_") and \
                not d.name.endswith(".tmp") and (d / _SENTINEL).exists():
            out.append(int(d.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = latest_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load(d: Path, k: str, meta: dict, verify: bool) -> np.ndarray:
    arr = np.load(d / meta["file"])
    if verify and _hash(arr) != meta["hash"]:
        raise IOError(f"checkpoint corruption detected in {k}")
    return arr


def restore_checkpoint(ckpt_dir, step: int, like_tree, *, shardings=None,
                       verify: bool = True, device=None):
    """Restore into the structure, shapes and dtypes of ``like_tree`` (its
    leaves may be meta tensors), on ``device`` (default: the card).

    ``shardings``: optional tree of ``dist.sharding.NamedSharding``
    matching ``like_tree``.  This is the elastic path: each saved array
    is placed onto the *current* mesh, as a DTensor on the mesh's device,
    whatever mesh it was saved from.
    """
    if shardings is not None:
        shards = leaves(shardings)
        if not shards or not all(isinstance(x, shd.NamedSharding)
                                 for x in shards):
            raise TypeError("shardings must be a tree of NamedSharding "
                            "(dist.sharding.named) matching like_tree")
        dev = shd.device_of(shards[0].mesh)
    else:
        dev = resolve_device(device)
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / _SENTINEL).read_text())
    expect: Dict[str, tuple] = {}
    for path, rep, leaf in walk(like_tree):
        k = key(path)
        n = expect[k][1] + 1 if k in expect else (1 if rep is not None
                                                   else 0)
        expect[k] = (tuple(leaf.shape), n)
    missing = set(expect) - set(manifest["arrays"])
    extra = set(manifest["arrays"]) - set(expect)
    if missing or extra:
        raise ValueError(f"checkpoint/tree mismatch: missing={missing} "
                         f"extra={extra}")
    loaded = {}
    for k, meta in manifest["arrays"].items():
        arr = _load(d, k, meta, verify)
        shape, repeats = expect[k]
        want = shape if not repeats else (repeats,) + shape
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {k}: saved {arr.shape} "
                             f"vs expected {want}")
        loaded[k] = _from_host(arr, meta["dtype"])

    def place(path, rep, like):
        t = loaded[key(path)]
        t = t if rep is None else t[rep]
        return t.to(device=dev, dtype=like.dtype, copy=True)
    out = fill(like_tree, place)
    if shardings is None:
        return out
    ts = leaves(out)
    if len(ts) != len(shards):
        raise ValueError(f"shardings hold {len(shards)} leaves; the tree "
                         f"{len(ts)}")
    return unflatten(out, [shd.place(t, sh) for t, sh in zip(ts, shards)])


def load_numpy(ckpt_dir, step: int, prefix: Optional[str] = None,
               verify: bool = True):
    """A checkpoint as the reference's tree of numpy arrays (dicts, and a
    list wherever its keys are indices; bf16 as float32, exactly), with
    no tree to restore into: e.g. ``load_numpy(..., prefix="params")``
    reads the params alone, and its ``["params"]`` is what
    ``lm.params_from_numpy`` takes."""
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / _SENTINEL).read_text())
    root: dict = {}
    for k, meta in manifest["arrays"].items():
        if prefix is not None and k.split("/")[0] != prefix:
            continue
        t = _from_host(_load(d, k, meta, verify), meta["dtype"])
        arr = (t.float() if meta["dtype"] in _EXOTIC else t).numpy()
        node, parts = root, k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(p.isdigit() for p in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {p: lists(v) for p, v in node.items()}
    return lists(root)
