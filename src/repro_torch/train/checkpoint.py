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
    a collective every rank joins) and rank 0 writes the unsharded
    layout, so ``restore_checkpoint(..., shardings=...)`` places it onto
    whatever mesh comes up (the reference's elastic re-mesh), or onto
    none;
  * streamed, for states no device or host holds whole: a sync save
    gathers one leaf at a time, only rank 0 copies it to the host (a
    stacked key's rows straight into its (R, ...) array), and each key
    is written and dropped before the next, so rank 0's host holds
    about the largest key; a restore onto a mesh has each key read and
    hashed by one rank (key ``j`` by rank ``j % world``), in a thread
    while the keys before it are placed, and each of its leaves sent to
    the other ranks' devices and placed at once, so the ranks share the
    reads, a rank's host holds one key and its device its shards plus
    one leaf whole.  The files are read, not mapped: on a four-H100 host
    with a 9p root and a tmpfs, a restore of qwen3-14b's 206.8 GB in
    which every rank mapped every key (``mmap_mode="r"``) did not finish
    in the five to nine minutes two runs had left for it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.convspec import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.tree import key, leaves, unflatten, walk

_SENTINEL = "manifest.json"
#: bytes hashed per call (hashlib releases the GIL while it hashes them)
_HASH_CHUNK = 1 << 26

# logical dtype -> (torch dtype, the numpy integer type of its bits)
_EXOTIC = {"bfloat16": (torch.bfloat16, np.uint16),
           "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8)}
_SIGNED = {np.uint16: torch.int16, np.uint8: torch.uint8}
_TORCH_NAME = {torch.float32: "float32", torch.float64: "float64",
               torch.float16: "float16", torch.int32: "int32",
               torch.int64: "int64", torch.int8: "int8",
               torch.uint8: "uint8", torch.bool: "bool"}


def _np(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _host_dtype(t: torch.Tensor):
    """(numpy dtype a tensor is saved as, logical dtype name)."""
    for name, (dt, bits) in _EXOTIC.items():
        if t.dtype == dt:
            return np.dtype(bits), name
    return _np(t.dtype), _TORCH_NAME[t.dtype]


def _to_host(t: torch.Tensor, out: Optional[np.ndarray] = None):
    """``t`` (a plain tensor) copied to the host as (array of its saved
    bits, logical dtype name): into ``out`` where given (a row of a
    stacked key's array), else into a new array; a copy, never a view of
    the tensor (the caller may update it in place afterwards).  The one
    place a save copies a tensor to the host."""
    np_dtype, name = _host_dtype(t)
    if name in _EXOTIC:
        t = t.view(_SIGNED[np_dtype.type])         # the raw bits
    if out is None:
        return t.to("cpu", copy=True).numpy().view(np_dtype), name
    torch.from_numpy(out.view(_np(t.dtype))).copy_(t)
    return out, name


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")       # keeps a 0-d array 0-d
    if dtype_name in _EXOTIC:
        dt, bits = _EXOTIC[dtype_name]
        raw = torch.from_numpy(arr.view(bits).view(
            np.int16 if bits is np.uint16 else np.uint8))
        return raw.view(dt)
    return torch.from_numpy(arr)


def _keys(tree) -> Dict[str, tuple]:
    """key -> (its leaves in repeat order, stacked?), in ``walk``'s order
    of first appearance."""
    out: Dict[str, tuple] = {}
    for path, rep, leaf in walk(tree):
        out.setdefault(key(path), ([], rep is not None))[0].append(leaf)
    return out


def _host_keys(tree, copy: bool) -> Iterator[tuple]:
    """(key, array in the reference's layout, dtype name), one key at a
    time.  Every leaf is gathered whole (a collective for a DTensor:
    every rank joins) and copied to the host only where ``copy``; else
    the array and name are None.  A stacked key's (R, ...) array is
    filled row by row."""
    for k, (ls, stacked) in _keys(tree).items():
        arr = name = None
        for r, leaf in enumerate(ls):
            t = shd.whole(leaf.detach())
            if copy and stacked:
                if arr is None:
                    arr = np.empty((len(ls),) + tuple(t.shape),
                                   _host_dtype(t)[0])
                name = _to_host(t, arr[r, ...])[1]
            elif copy:
                arr, name = _to_host(t)
            del t                     # one leaf whole on the device at once
        yield k, arr, name


def _update(h, arr: np.ndarray) -> None:
    """Feed ``arr``'s C-order bytes (``arr.tobytes()``) to the hash
    ``h`` in chunks, without copying the array."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    for i in range(0, flat.size, _HASH_CHUNK):
        h.update(flat[i:i + _HASH_CHUNK])


def _hash(arr: np.ndarray) -> str:
    """The manifest's hash: a sha256 prefix of the array's bytes."""
    h = hashlib.sha256()
    _update(h, arr)
    return h.hexdigest()[:16]


def _write(ckpt_dir: Path, step: int, items, keep: int):
    """Write ``items`` ((key, array, dtype name), consumed one at a time,
    each array hashed while it is written) as ``step_{step}``, publish
    it, and remove the oldest beyond ``keep``."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "arrays": {}}
    with ThreadPoolExecutor(1) as pool:
        for k, enc, dtype_name in items:
            fname = hashlib.md5(k.encode()).hexdigest()[:12] + ".npy"
            digest = pool.submit(_hash, enc)
            np.save(tmp / fname, enc)
            manifest["arrays"][k] = {
                "file": fname, "shape": list(enc.shape), "dtype": dtype_name,
                "hash": digest.result(),
            }
            del enc, digest
    (tmp / _SENTINEL).write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)


def save_checkpoint(ckpt_dir, step: int, tree, *, async_=False,
                    keep: int = 3):
    """Write ``tree`` as ``ckpt_dir/step_{step}``; returns its path, or
    with ``async_`` the started writer thread.  A tree of DTensors is a
    collective call: every rank gathers each leaf, rank 0 alone copies
    and writes, and a sync save returns on every rank once the
    checkpoint is published (an async one returns None on the other
    ranks).  A sync save streams one key at a time; an async one copies
    every key to rank 0's host before its writer starts."""
    ckpt_dir = Path(ckpt_dir)
    sharded = any(isinstance(t, DTensor) for t in leaves(tree))
    writer = not sharded or dist.get_rank() == 0
    keys = _host_keys(tree, copy=writer)
    if async_:
        host = list(keys)          # device -> host before the writer starts
        if not writer:
            return None
        t = threading.Thread(target=_write, args=(ckpt_dir, step, host, keep),
                             daemon=True)
        t.start()
        return t
    if writer:
        _write(ckpt_dir, step, keys, keep)
    else:
        for _ in keys:
            pass
    if sharded:
        dist.barrier()
    return ckpt_dir / f"step_{step}" if writer else None


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


def _load(d: Path, k: str, meta: dict) -> np.ndarray:
    """The saved array of key ``k``."""
    return np.load(d / meta["file"])


def _read(d: Path, k: str, meta: dict, verify: bool):
    """(key ``k``'s saved array, its hash where ``verify``, else None)."""
    arr = _load(d, k, meta)
    if list(arr.shape) != list(meta["shape"]):
        raise ValueError(f"shape mismatch for {k}: file {arr.shape} vs "
                         f"manifest {tuple(meta['shape'])}")
    return arr, _hash(arr) if verify else None


def restore_checkpoint(ckpt_dir, step: int, like_tree, *, shardings=None,
                       verify: bool = True, device=None):
    """Restore into the structure, shapes and dtypes of ``like_tree`` (its
    leaves may be meta tensors), on ``device`` (default: the card).

    ``shardings``: optional tree of ``dist.sharding.NamedSharding``
    matching ``like_tree``.  This is the elastic path: each saved array
    is placed onto the *current* mesh, as a DTensor on the mesh's device,
    whatever mesh it was saved from.  It is a collective call over the
    default process group: key ``j`` is read and hashed by rank ``j %
    world`` alone (in a thread, while the keys before it are placed), its
    leaves broadcast from that rank's device one at a time and each
    placed at once, and the ranks agree on the hashes' verdict.  So a
    rank's host holds at most one key, and its device its shards plus
    one leaf whole.
    """
    like = list(walk(like_tree))
    if shardings is not None:
        shards = leaves(shardings)
        if not shards or not all(isinstance(x, shd.NamedSharding)
                                 for x in shards):
            raise TypeError("shardings must be a tree of NamedSharding "
                            "(dist.sharding.named) matching like_tree")
        if len(shards) != len(like):
            raise ValueError(f"shardings hold {len(shards)} leaves; the "
                             f"tree {len(like)}")
        dev = shd.device_of(shards[0].mesh)
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        dev = resolve_device(device)
        rank, world = 0, 1
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / _SENTINEL).read_text())
    groups: Dict[str, list] = {}
    for i, (path, rep, leaf) in enumerate(like):
        groups.setdefault(key(path), []).append((i, rep, leaf))
    missing = set(groups) - set(manifest["arrays"])
    extra = set(manifest["arrays"]) - set(groups)
    if missing or extra:
        raise ValueError(f"checkpoint/tree mismatch: missing={missing} "
                         f"extra={extra}")
    items = list(manifest["arrays"].items())
    for k, meta in items:
        group = groups[k]
        shape = tuple(group[0][2].shape)
        want = shape if group[0][1] is None else (len(group),) + shape
        if tuple(meta["shape"]) != want:
            raise ValueError(f"shape mismatch for {k}: saved "
                             f"{tuple(meta['shape'])} vs expected {want}")
    out = [None] * len(like)
    mine = [j for j in range(len(items)) if j % world == rank]
    bad = []
    with ThreadPoolExecutor(1) as pool:
        def read(n):
            """The read of this rank's ``n``-th key, started."""
            if n >= len(mine):
                return None
            k, meta = items[mine[n]]
            return pool.submit(_read, d, k, meta, verify)
        pending, n = read(0), 1
        for j, (k, meta) in enumerate(items):
            src = j % world
            if src == rank:
                try:
                    arr, digest = pending.result()
                    failed = None
                except Exception as e:         # told to the other ranks
                    failed = e
                pending = None        # the future must not keep the array
            if shardings is not None and world > 1:
                flag = torch.tensor([int(src == rank and failed is not None)],
                                    device=dev)
                dist.broadcast(flag, src)
                if int(flag.item()) and src != rank:
                    raise IOError(f"checkpoint key {k} could not be read "
                                  f"on rank {src}")
            if src == rank:
                if failed is not None:
                    raise failed
                if digest is not None and digest != meta["hash"]:
                    bad.append(k)
            for i, rep, leaf in groups[k]:     # the rows, in order
                if src == rank:
                    row = arr if rep is None else arr[rep, ...]
                    t = _from_host(row, meta["dtype"]).to(
                        device=dev, dtype=leaf.dtype, copy=True)
                    del row
                else:
                    t = torch.empty(leaf.shape, dtype=leaf.dtype, device=dev)
                if shardings is not None:      # the whole copy goes here
                    if world > 1:
                        dist.broadcast(t.reshape(-1).view(torch.uint8), src)
                    t = shd.own(shd.place(t, shards[i]))
                out[i] = t
                del t
            if src == rank:
                del arr
                pending, n = read(n), n + 1
    if shardings is not None and verify:
        flag = torch.tensor([len(bad)], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if int(flag.item()) and not bad:
            bad.append("a key another rank read")
    if bad:
        raise IOError(f"checkpoint corruption detected in {bad[0]}")
    return unflatten(like_tree, out)


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
        arr = _load(d, k, meta)
        if verify and _hash(arr) != meta["hash"]:
            raise IOError(f"checkpoint corruption detected in {k}")
        t = _from_host(arr, meta["dtype"])
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
