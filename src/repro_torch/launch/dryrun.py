"""Multi-pod dry-run: the JAX package's ``launch/dryrun.py`` on
``torch.distributed``.

For every (architecture x input-shape x mesh) cell this runs the real
sharded train, prefill or decode step of the port on the production
mesh, (16, 16) or (2, 16, 16), and counts what one rank does.  Nothing
is allocated: the placeholders are meta tensors placed as DTensors over
a ``"fake"`` process group of 256 or 512 ranks that ``main()`` brings up
in this one process, so every op runs on shapes alone and every
collective moves nothing.  This is the counterpart of the reference's
512 placeholder CPU devices; ``lower_cell`` itself brings up no group.

What replaces ``lowered``/``compiled``: ``CostCounter``, a
``TorchDispatchMode`` around the step.  It lets DTensor turn each call
into the local ops and collectives of one rank (it returns
``NotImplemented`` where a ``DTensor`` is among the types, as
``CommDebugMode`` does) and skips the FakeTensor calls of DTensor's
sharding propagation, which run at global shapes.  Per rank it counts

  * FLOPs of the local ops by ``torch.utils.flop_counter``'s formulas
    (matmuls, convs, attention; the kernels ``repro_torch::
    flash_attention`` and ``conv1d_tap`` by their own, ``kernels/``);
  * bytes as the sum of each local op's input and output bytes: the HBM
    traffic of the eager, unfused step the port runs (views and
    allocations move nothing);
  * collectives by kind (the reference's names), count and output
    bytes.  On this CPU mesh DTensor issues an all-gather and a local
    chunk where a card mesh issues an all-to-all (``shard_dim_alltoall``
    has no gloo path), so such a move counts as an all-gather here;
  * nothing of DTensor's own bookkeeping: the decompositions it runs
    while it looks for an op's sharding rule, and the index tensors of
    its shard offsets (``_bookkeeping``);
  * memory: the argument bytes (the local shards of the state, batch
    and cache) and the most bytes live at once among the tensors the
    step made (``weakref.finalize`` on each new storage); ``peak_bytes``
    is their sum, as in the reference.

Counting eagerly is exact at any depth, but its host time grows with
layers x micro-batches, so each cell is counted on the unrolled 1- and
2-period probes at grad_accum 1 (``probe_variant``) and extrapolated
linearly to the full depth, as in the reference.  The record's
top-level counts are the 1-period probe's (the reference's are XLA's,
which counts a scanned layer once); ``probe`` holds the full-depth
totals, and ``memory`` the full-depth argument bytes and the
extrapolated temporaries.  ``compile_s`` is the seconds of the cell's
meta runs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--resume]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs)
from repro_torch.dist import sharding as sh
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm

# long-context decode is only defined for sub-quadratic archs
LONG_OK_FAMILIES = ("ssm", "hybrid")


def cell_defined(cfg, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.family in LONG_OK_FAMILIES
    return True


# ---------------------------------------------------------------------------
# the per-rank counter

#: collective ops -> the reference's kind names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "c10d", "_dtensor")
#: ops that allocate or only wait: no bytes moved
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "wait_tensor", "_local_scalar_dense",
               "lift_fresh", "set_", "resize_", "record_stream"}


def _tensors(tree) -> List[torch.Tensor]:
    out = []
    torch.utils._pytree.tree_map(
        lambda t: out.append(t) if isinstance(t, torch.Tensor) else None,
        tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: DTensor's own bookkeeping, not a rank's work: the decompositions it
#: runs while it looks for an op's sharding rule (a first call), and the
#: index tensors of its shard offsets (more of them on a first call)
_DTENSOR_DECOMP = "torch/distributed/tensor/_decompositions.py"
_DTENSOR_PLACEMENTS = "torch/distributed/tensor/placement_types.py"


def _bookkeeping(tensors, depth: int = 16) -> bool:
    """Whether the op being counted was called from DTensor's
    bookkeeping (``_DTENSOR_DECOMP``, or integer index tensors made in
    ``_DTENSOR_PLACEMENTS``).  Its count would differ between a first
    call and a later one, and a probe's would not extrapolate."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        name = f.f_code.co_filename
        if name.endswith(_DTENSOR_DECOMP):
            return True
        if name.endswith(_DTENSOR_PLACEMENTS):
            return all(not t.is_floating_point() for t in tensors)
        f = f.f_back
    return False


def _is_view(func) -> bool:
    """An op whose output aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class CostCounter(TorchDispatchMode):
    """What one rank does in the code it wraps: ``flops`` (and
    ``flops_by_op``, by op name), ``bytes``,
    ``collectives`` (a list of ``(kind, output bytes)``) and the peak of
    the bytes live among the tensors it made (``peak_temp``).  Tensors
    made before it (the step's arguments) are not temporaries; pass them
    as ``arguments`` so that an in-place write into one is not counted
    as one."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.bytes = 0
        self.collectives: List[Tuple[str, int]] = []
        self.live = 0
        self.peak_temp = 0
        self._known = {_key(t) for t in _tensors(arguments)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        # DTensor's sharding propagation runs ops, and makes their
        # inputs, as FakeTensors at global shapes: not a rank's work
        if (isinstance(func, torch._ops.HigherOrderOperator)
                or torch._C._meta_in_tls_dispatch_include()
                or any(issubclass(t, FakeTensor) for t in types)
                or any(isinstance(t, FakeTensor) for t in _tensors(out))):
            return out
        if _bookkeeping(_tensors((args, out))):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if (name in _COLLECTIVES
                and func.namespace in _COLLECTIVE_NS):
            outs = _tensors(out) or _tensors(args[:1])
            self.collectives.append(
                (_COLLECTIVES[name], sum(_nbytes(t) for t in outs)))
        elif name not in _NO_TRAFFIC and not _is_view(func):
            from torch.utils.flop_counter import flop_registry
            if packet in flop_registry:
                n = int(flop_registry[packet](*args, out_val=out, **kwargs))
                self.flops += n
                self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        if not _is_view(func):
            for t in _tensors(out):
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        k = storage._cdata
        if k in self._known:
            return
        self._known.add(k)
        n = storage.nbytes()
        self.live += n
        self.peak_temp = max(self.peak_temp, self.live)
        weakref.finalize(storage, self._free, k, n)

    def _free(self, k, n) -> None:
        self._known.discard(k)
        self.live -= n


def _key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def collective_bytes(records) -> Dict[str, Dict[str, int]]:
    """``{kind: {"count", "bytes"}}`` from a counter's collectives (a
    ``CostCounter`` or its list of ``(kind, output bytes)``): output
    bytes per rank, summed per kind, as the reference sums its HLO's."""
    records = getattr(records, "collectives", records)
    out: Dict[str, Dict[str, int]] = {}
    for kind, b in records:
        if b == 0:
            continue
        d = out.setdefault(kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += b
    return out


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree of tensors and DTensors."""
    return sum(_nbytes(sh.local_shard(t)) for t in _tensors(tree))


# ---------------------------------------------------------------------------
# counting per cell

def probe_variant(cfg, n_periods: int):
    """Unrolled small-stack twin of cfg for counting: ``n_periods``
    periods of its layer pattern at grad_accum 1.  A period's ops are the
    same at every depth, so the 1- and 2-period counts extrapolate
    linearly to the full stack, exactly for FLOPs, bytes and
    collectives."""
    kw = dict(scan_layers=False, attn_impl="chunked_unrolled", grad_accum=1)
    if cfg.first_layer_dense:
        # probe as uniform MoE stack; layer-0 dense MLP (10944) has nearly
        # the same cost as shared+routed-active
        kw["first_layer_dense"] = False
    c0 = dataclasses.replace(cfg, **kw)
    period = c0.pattern_period or 1
    return dataclasses.replace(c0, num_layers=period * n_periods), period


def apply_overrides(cfg, overrides):
    """--set key=value config variants."""
    if not overrides:
        return cfg
    kw = {}
    for kv in overrides:
        k, v = kv.split("=", 1)
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            v = int(v)
        elif isinstance(cur, float):
            v = float(v)
        kw[k] = v
    return dataclasses.replace(cfg, **kw)


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def cell_arguments(cfg: ModelConfig, shape, mesh, multi_pod: bool = False,
                   act_seq_shard: bool = False):
    """The step of a cell and its arguments, placed on ``mesh`` by the
    rules: ``(step, args)``.  The state, batch and cache are meta
    tensors; the train state's step counter is a 0-d host tensor (the
    schedule reads it on the host)."""
    shape = _shape(shape)
    long_ctx = shape.name == "long_500k"
    rules = sh.make_rules(shape.kind, multi_pod, long_context=long_ctx)
    batch = St.input_specs(cfg, shape)
    bspecs = sh.named(mesh, sh.batch_specs(batch, rules))
    batch = {k: sh.place(v, bspecs[k]) for k, v in batch.items()}
    # sequence-sharded residual stream ("SP"): the residual's sequence
    # axis over 'model' at every layer boundary (layers.maybe_constrain)
    act = sh.named(mesh, sh.P(rules["batch"], "model", None) if act_seq_shard
                   else sh.P(rules["batch"], None, None))
    names = mesh.mesh_dim_names
    dp = 1
    if not long_ctx:
        for a in ("pod", "data"):
            if a in names:
                dp *= mesh.shape[names.index(a)]
    if shape.kind == "train":
        state = St.state_specs(cfg)
        pspecs = sh.param_specs(state["params"], rules)
        state = {"params": sh.place_tree(state["params"],
                                         sh.named(mesh, pspecs)),
                 "opt": sh.place_tree(state["opt"], sh.named(
                     mesh, sh.opt_specs(pspecs))),
                 "step": torch.zeros((), dtype=torch.int32)}
        step = St.make_train_step(cfg, act_spec=act, moe_groups=dp,
                                  donate=True)
        return step, (state, batch)
    params = lm.init_lm(cfg, device="meta")
    params = sh.place_tree(params, sh.named(mesh, sh.param_specs(params,
                                                                 rules)))
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device="meta")
    cache = sh.place_tree(cache, sh.named(mesh, sh.cache_specs(cache, cfg,
                                                               rules)))
    if shape.kind == "prefill":
        step = St.make_prefill_step(cfg, shape.seq_len, act_spec=act,
                                    moe_groups=dp)
        return step, (params, batch, cache)
    step = St.make_decode_step(cfg, act_spec=act)
    return step, (params, batch, cache, shape.seq_len - 1)


def count(step, args) -> Dict:
    """``step(*args)`` under a ``CostCounter``: the counts of one rank,
    in the record's keys."""
    arg_bytes = local_bytes(args)
    counter = CostCounter(arguments=[sh.local_shard(t)
                                     for t in _tensors(args)])
    with counter:
        out = step(*args)
    colls = collective_bytes(counter)
    return {"flops_per_device": float(counter.flops),
            "bytes_accessed_per_device": float(counter.bytes),
            "collectives": colls,
            "collective_bytes_per_device": sum(v["bytes"]
                                               for v in colls.values()),
            "memory": {"argument_bytes": arg_bytes,
                       "output_bytes": local_bytes(out),
                       "temp_bytes": counter.peak_temp,
                       "peak_bytes": arg_bytes + counter.peak_temp}}


def lower_cell(arch: str, shape_name, multi_pod: bool, cfg=None,
               act_seq_shard: bool = False, mesh=None):
    """Run one cell's step on meta placeholders under the counter: the
    counterpart of the reference's lower + compile.  Returns ``(cfg,
    shape, mesh, record)``, the record holding the counts of one rank
    (``count``).  ``mesh`` defaults to the production mesh, over the
    process group already up (256 or 512 ranks; ``main`` brings up a
    fake one).  ``shape_name`` may be a ``ShapeConfig``."""
    cfg = cfg or get_config(arch)
    shape = _shape(shape_name)
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    step, args = cell_arguments(cfg, shape, mesh, multi_pod, act_seq_shard)
    return cfg, shape, mesh, count(step, args)


def _tag(arch, shape_name, multi_pod, variant=""):
    tag = f"{arch}__{shape_name}__{'multipod' if multi_pod else 'pod'}"
    return f"{tag}__{variant}" if variant else tag


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             verbose=True, overrides=None, act_seq_shard=False,
             variant: str = ""):
    t0 = time.time()
    out_dir = Path(out_dir)
    cfg = apply_overrides(get_config(arch), overrides)
    tag = _tag(arch, shape_name, multi_pod, variant)
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not cell_defined(cfg, shape_name):
        rec["status"] = "SKIP(full-attn)"
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
        print(f"[dryrun] {tag}: SKIP (full-attention arch, long_500k "
              "needs a sub-quadratic path)")
        return rec
    try:
        shape = SHAPES[shape_name]
        pc1, period = probe_variant(cfg, 1)
        pc2, _ = probe_variant(cfg, 2)
        n_periods = cfg.num_layers // period
        mesh = make_production_mesh(multi_pod=multi_pod)
        c1, c2 = (lower_cell(arch, shape_name, multi_pod, cfg=pc,
                             act_seq_shard=act_seq_shard, mesh=mesh)[3]
                  for pc in (pc1, pc2))
        ext = lambda a, b: a + (n_periods - 1) * (b - a)
        cb1, cb2 = c1["collectives"], c2["collectives"]
        probe = {
            "period": period,
            "n_periods": n_periods,
            "flops_total_per_device": ext(c1["flops_per_device"],
                                          c2["flops_per_device"]),
            "bytes_total_per_device": ext(
                c1["bytes_accessed_per_device"],
                c2["bytes_accessed_per_device"]),
            "collective_bytes_total_per_device": ext(
                c1["collective_bytes_per_device"],
                c2["collective_bytes_per_device"]),
            "collectives_by_kind": {
                k: ext(cb1.get(k, {}).get("bytes", 0),
                       cb2.get(k, {}).get("bytes", 0))
                for k in set(cb1) | set(cb2)},
        }
        m1, m2 = c1["memory"], c2["memory"]
        # the full depth's arguments, placed and not run
        arg = local_bytes(cell_arguments(cfg, shape, mesh, multi_pod)[1])
        temp = ext(m1["temp_bytes"], m2["temp_bytes"])
        rec.update({
            "status": "OK",
            "devices": mesh.size(),
            "compile_s": round(time.time() - t0, 1),
            "flops_per_device": c1["flops_per_device"],
            "bytes_accessed_per_device": c1["bytes_accessed_per_device"],
            "collectives": c1["collectives"],
            "collective_bytes_per_device": c1["collective_bytes_per_device"],
            "probe": probe,
            "memory": {
                "argument_bytes": arg,
                "output_bytes": ext(m1["output_bytes"], m2["output_bytes"]),
                "temp_bytes": temp,
                "peak_bytes": arg + temp,
            },
            "params": cfg.num_params(),
            "active_params": cfg.num_active_params(),
            "tokens": shape.global_batch * (shape.seq_len
                                            if shape.kind != "decode" else 1),
            "kind": shape.kind,
        })
        if verbose:
            print(f"[dryrun] {tag}: OK in {rec['compile_s']}s  "
                  f"flops/dev={probe['flops_total_per_device']:.3e}  "
                  f"bytes/dev={probe['bytes_total_per_device']:.3e}  "
                  f"coll_bytes/dev="
                  f"{probe['collective_bytes_total_per_device']:.3e}  "
                  f"temp={temp / 2**30:.2f}GiB", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {tag}: FAIL {type(e).__name__}: {str(e)[:300]}",
              flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return rec


def fake_world(n: int) -> None:
    """A ``"fake"`` process group of ``n`` ranks in this process (rank
    0), in place of one of another size that this module brought up.  A
    real group of another world size raises; one of this size is
    kept."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is up; the dry-run needs "
                f"{n} ranks (a fake group it brings up itself)")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose artifact already exists and is OK")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="config override key=value (repeatable); "
                         "e.g. --set ce_impl=chunked --set remat=dots")
    ap.add_argument("--act-seq-shard", action="store_true",
                    help="sequence-shard the residual stream over 'model'")
    ap.add_argument("--variant", default="",
                    help="tag appended to the artifact name")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]

    results = []
    t0 = time.time()
    for mp in meshes:
        fake_world(512 if mp else 256)
        for arch in archs:
            for shape in shapes:
                f = out_dir / f"{_tag(arch, shape, mp, args.variant)}.json"
                if args.resume and f.exists():
                    rec = json.loads(f.read_text())
                    if rec.get("status", "").startswith(("OK", "SKIP")):
                        print(f"[dryrun] {f.stem}: cached ({rec['status']})")
                        results.append(rec)
                        continue
                results.append(run_cell(
                    arch, shape, mp, out_dir, overrides=args.overrides,
                    act_seq_shard=args.act_seq_shard, variant=args.variant))
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()
    bad = [r for r in results if r["status"].startswith("FAIL")]
    print(f"[dryrun] done: {len(results)} cells, {len(bad)} failures in "
          f"{time.time() - t0:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
