"""The port's dry-run (``repro_torch.launch.dryrun``) and its per-rank
counter, mirroring ``tests/test_dryrun_utils.py``, on the CPU in one
process: meta placeholders on a ``"fake"`` process group of 16 or 256
ranks (no 512-rank sweep here)."""
import dataclasses
import json

import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jbase
from repro.launch import dryrun as jdr
from repro.launch.steps import input_specs as jinput_specs
from repro_torch.configs.base import SHAPES, ShapeConfig, get_config, \
    list_archs, smoke_variant
from repro_torch.kernels import _build, ops
from repro_torch.launch import dryrun as D
from repro_torch.launch.steps import input_specs
from repro_torch.models.lm import stack_plan


@pytest.fixture
def world():
    """``D.fake_world(n)``, torn down after the test."""
    yield D.fake_world
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference's six utility tests, against the reference's functions

def test_apply_overrides_types():
    sets = ["ce_impl=chunked", "grad_accum=8", "capacity_factor=2.0",
            "scan_layers=false"]
    out = D.apply_overrides(get_config("qwen2-1.5b"), sets)
    assert out.ce_impl == "chunked" and out.grad_accum == 8
    assert out.capacity_factor == 2.0 and out.scan_layers is False
    ref = jdr.apply_overrides(jbase.get_config("qwen2-1.5b"), sets)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)


def test_probe_variant_periods():
    for arch in list_archs():
        cfg = get_config(arch)
        pc1, period = D.probe_variant(cfg, 1)
        pc2, _ = D.probe_variant(cfg, 2)
        assert pc1.num_layers == period and pc2.num_layers == 2 * period
        assert not pc1.scan_layers and pc1.grad_accum == 1
        stack_plan(pc1), stack_plan(pc2)
        if arch == "jamba-v0.1-52b":
            assert period == 8          # lcm(pattern=8, moe_every=2)
        r2, rperiod = jdr.probe_variant(jbase.get_config(arch), 2)
        assert dataclasses.asdict(pc2) == dataclasses.asdict(r2)
        assert period == rperiod


def test_long_500k_skip_policy():
    runs = [a for a in list_archs()
            if D.cell_defined(get_config(a), "long_500k")]
    assert sorted(runs) == ["jamba-v0.1-52b", "mamba2-1.3b"]
    assert D.LONG_OK_FAMILIES == jdr.LONG_OK_FAMILIES
    for a in list_archs():
        for s in SHAPES:
            assert D.cell_defined(get_config(a), s) == jdr.cell_defined(
                jbase.get_config(a), s)


def test_input_specs_shapes():
    for arch in list_archs():
        cfg, jcfg = get_config(arch), jbase.get_config(arch)
        for sname, shape in SHAPES.items():
            spec = input_specs(cfg, shape)
            want = jinput_specs(jcfg, jbase.SHAPES[sname])
            assert set(spec) == set(want)
            for k, v in spec.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == tuple(want[k].shape), (arch, k)
            assert ("labels" in spec) == (shape.kind == "train")


def test_collective_count_ignores_waits_and_empty_records(world):
    """A redistribute's all-gather is one record of its output bytes (the
    ``wait_tensor`` that completes it is not a second); records of no
    bytes are dropped, as the reference drops its zero-byte lines."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_production_mesh
    world(256)
    mesh = make_production_mesh()
    t = distribute_tensor(torch.empty((256, 1024), dtype=torch.bfloat16,
                                      device="meta"), mesh,
                          [Shard(0), Shard(1)], src_data_rank=None)
    with D.CostCounter() as c:
        t.redistribute(placements=[Replicate(), Shard(1)])
    # each rank gathers its (16, 64) bf16 shard over 'data': (256, 64)
    assert D.collective_bytes(c) == {"all-gather": {"count": 1,
                                                    "bytes": 256 * 64 * 2}}
    assert D.collective_bytes([("all-reduce", 8), ("all-reduce", 0),
                               ("all-gather", 4)]) == {
        "all-reduce": {"count": 1, "bytes": 8},
        "all-gather": {"count": 1, "bytes": 4}}
    hlo = "%all-reduce.1 = f32[2]{0} all-reduce(%x)\n"
    assert set(jdr.collective_bytes(hlo)) == set(D.collective_bytes(
        [("all-reduce", 8)]))


def test_padded_vocab_divisibility():
    for arch in list_archs():
        cfg = get_config(arch)
        assert cfg.padded_vocab % 256 == 0
        assert cfg.padded_vocab >= cfg.vocab_size
        assert cfg.padded_vocab % 16 == 0
        assert cfg.padded_vocab == jbase.get_config(arch).padded_vocab


# ---------------------------------------------------------------------------
# the counter counts one rank

def test_sharded_matmul_flops_are_per_rank(world):
    """x (256, 4096) cut over 'data' @ w (4096, 1024) cut over 'model' on
    the 16 x 16 mesh, forward and backward from a gradient placed as the
    product: each rank computes (16, 4096) @ (4096, 64) and its two
    gradients' products, 3 x 2 x 16 x 4096 x 64 FLOPs;
    FlopCounterMode sees the DTensor calls at their global shapes."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch.mesh import make_production_mesh
    world(256)
    mesh = make_production_mesh()

    def run():
        x = distribute_tensor(torch.empty((256, 4096), device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty((4096, 1024), device="meta"),
                              mesh, [Replicate(), Shard(1)],
                              src_data_rank=None)
        gy = distribute_tensor(torch.empty((256, 1024), device="meta"),
                               mesh, [Shard(0), Shard(1)],
                               src_data_rank=None)
        x.requires_grad_(True)
        w.requires_grad_(True)
        (x @ w).backward(gy)

    with D.CostCounter() as c:
        run()
    assert c.flops == 3 * 2 * 16 * 4096 * 64
    with FlopCounterMode(display=False) as fc:
        run()
    assert fc.get_total_flops() == 3 * 2 * 256 * 4096 * 1024 != c.flops


def test_kernels_on_meta_charge_their_formulas_and_launch_nothing():
    before = dict(_build.LAUNCHES)
    q = torch.empty((2, 64, 4, 16), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((2, 64, 2, 16), dtype=torch.bfloat16, device="meta")
    x = torch.empty((2, 64, 32), dtype=torch.bfloat16, device="meta")
    w = torch.empty((4, 32), dtype=torch.bfloat16, device="meta")
    with D.CostCounter() as c:
        o = ops.flash_attention(q, kv, kv)
        y = ops.conv1d_causal(x, w, w[0])
    assert o.shape == q.shape and y.shape == x.shape
    assert o.device.type == y.device.type == "meta"
    assert o.dtype == y.dtype == torch.bfloat16
    assert c.flops == 4 * 16 * 2 * 4 * (64 * 65 // 2) + 2 * 4 * x.numel()
    # q, k, v and out; x, w, b and y
    assert c.bytes == 2 * (2 * q.numel() + 2 * kv.numel()) + 2 * (
        2 * x.numel() + w.numel() + 32)
    assert _build.LAUNCHES == before


# ---------------------------------------------------------------------------
# cells

SMALL = {"train": ShapeConfig("train_s", 32, 8, "train"),
         "prefill": ShapeConfig("prefill_s", 32, 8, "prefill"),
         "decode": ShapeConfig("decode_s", 32, 8, "decode")}


def _small(arch, **kw):
    return dataclasses.replace(smoke_variant(get_config(arch)), **kw)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b",
                                  "jamba-v0.1-52b"])
def test_probe_extrapolation_equals_a_full_depth_count(arch, world):
    """Dense, MoE and hybrid smoke variants on a (4, 4) mesh: the 1- and
    2-period counts extrapolated to 3 periods equal the count of the
    3-period stack (FLOPs, bytes, collective bytes and counts); the first
    count of the process is one of them (DTensor's first-call
    bookkeeping is not counted)."""
    from repro_torch.launch.mesh import make_debug_mesh
    world(16)
    mesh = make_debug_mesh(model=4)
    cfg = _small(arch)
    recs = [D.lower_cell(arch, SMALL["train"], False, mesh=mesh,
                         cfg=D.probe_variant(cfg, n)[0])[3]
            for n in (1, 2, 3)]
    ext = lambda k: recs[0][k] + 2 * (recs[1][k] - recs[0][k])
    for k in ("flops_per_device", "bytes_accessed_per_device",
              "collective_bytes_per_device"):
        assert recs[2][k] == ext(k) > 0, k
    for kind, v in recs[2]["collectives"].items():
        c0, c1 = (r["collectives"][kind]["count"] for r in recs[:2])
        assert v["count"] == c0 + 2 * (c1 - c0)


@pytest.mark.parametrize("kind", sorted(SMALL))
def test_a_smoke_cell_of_each_kind_counts_on_a_4x4_mesh(kind, world):
    from repro_torch.launch.mesh import make_debug_mesh
    world(16)
    mesh = make_debug_mesh(model=4)
    cfg = _small("qwen2-1.5b", num_heads=6, grad_accum=1)
    _, shape, m, rec = D.lower_cell("qwen2-1.5b", SMALL[kind], False,
                                    cfg=cfg, mesh=mesh)
    assert tuple(m.shape) == (4, 4) and shape.kind == kind
    assert rec["flops_per_device"] > 0 and rec["bytes_accessed_per_device"]
    assert rec["collective_bytes_per_device"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] > 0 and mem["argument_bytes"] > 0


def test_a_train_4k_cell_on_the_pod_mesh(world):
    """qwen2-1.5b's 1-period probe at train_4k on 16 x 16: 12 query and
    2 kv heads over a 'model' axis of 16, one rank's FLOPs at least the
    6·N_layer·tokens share of its 256th of the batch."""
    world(256)
    cfg, _ = D.probe_variant(get_config("qwen2-1.5b"), 1)
    _, shape, mesh, rec = D.lower_cell("qwen2-1.5b", "train_4k", False,
                                       cfg=cfg)
    assert mesh.size() == 256
    layer = (cfg.num_params() - 2 * cfg.padded_vocab * cfg.d_model) // 1
    tokens = shape.global_batch * shape.seq_len
    assert rec["flops_per_device"] >= 6 * layer * tokens / 256
    assert set(rec["collectives"]) <= {"all-gather", "all-reduce",
                                       "reduce-scatter", "all-to-all"}


def test_a_train_4k_batch_under_the_batch_ranks_on_the_pod_mesh(world):
    """qwen2-1.5b's 1-period probe at train_4k with a batch of 8 rows on
    16 x 16: 8 rows do not divide over 'data' = 16 (as a micro-batch of
    16 rows does not over the multi-pod mesh's 32 batch ranks in
    qwen2-72b's real step).  The batch and the activations are
    replicated over 'data', so the step lowers and each rank computes
    all 8 rows: at least a 16th ('model') of 6·N_layer·tokens."""
    world(256)
    cfg, _ = D.probe_variant(get_config("qwen2-1.5b"), 1)
    shape = ShapeConfig("train_4k", 4096, 8, "train")
    _, _, mesh, rec = D.lower_cell("qwen2-1.5b", shape, False, cfg=cfg)
    assert mesh.size() == 256
    layer = cfg.num_params() - 2 * cfg.padded_vocab * cfg.d_model
    tokens = shape.global_batch * shape.seq_len
    assert rec["flops_per_device"] >= 6 * layer * tokens / 16
    assert rec["memory"]["argument_bytes"] > 0


def test_the_cli_writes_records_and_refuses_another_group(tmp_path):
    """``main`` brings up its own fake group: a decode cell comes out OK
    with the reference's keys, a long_500k cell of a full-attention arch
    SKIP; a gloo group of another size already up raises."""
    out = tmp_path / "art"
    assert D.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                   "--out", str(out)]) == 0
    assert not dist.is_initialized()
    rec = json.loads((out / "qwen2-1.5b__decode_32k__pod.json").read_text())
    assert rec["status"] == "OK" and rec["devices"] == 256
    for k in ("devices", "flops_per_device", "bytes_accessed_per_device",
              "collectives", "collective_bytes_per_device", "probe",
              "memory", "params", "active_params", "tokens", "kind",
              "compile_s"):
        assert k in rec, k
    assert rec["tokens"] == 128 and rec["kind"] == "decode"
    assert D.main(["--arch", "qwen2-1.5b", "--shape", "long_500k",
                   "--out", str(out)]) == 0
    skip = json.loads((out / "qwen2-1.5b__long_500k__pod.json").read_text())
    assert skip["status"] == "SKIP(full-attn)"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="needs 256 ranks"):
            D.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                    "--out", str(out)])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("model", [4, 2])
def test_a_train_step_holds_each_gradient_at_its_params_placements(world,
                                                                  model):
    """qwen3-14b's train step at full width on a meta mesh of four fake
    ranks, (1, 4) and (2, 2), grad_accum 1: a second layer adds at most
    its own gradients, at their params' placements (a 'model' and 'data'
    shard, bf16), to the peak of the step's temporaries.  Brought to the
    params' placements only after the backward, every layer's gradients
    were held partial or whole until it ended (2.9 and 2.0 times that on
    the two meshes), which the full 40 layers on (1, 4) do not fit on an
    80 GB card beside the state."""
    from repro_torch.launch.mesh import make_debug_mesh
    world(4)
    mesh = make_debug_mesh(model=model)
    cfg = dataclasses.replace(get_config("qwen3-14b"), grad_accum=1)
    shape = ShapeConfig("train_cut", 512, 2, "train")
    peaks = [D.lower_cell("qwen3-14b", shape, False, mesh=mesh,
                          cfg=dataclasses.replace(cfg, num_layers=n))[3]
             ["memory"]["temp_bytes"] for n in (1, 2)]
    layer = (cfg.num_params() - 2 * cfg.padded_vocab * cfg.d_model) \
        // cfg.num_layers
    assert peaks[1] - peaks[0] <= 1.05 * layer * 2 / 4, peaks
