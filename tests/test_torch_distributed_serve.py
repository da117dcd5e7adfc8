"""The port's multi-device sharded serving against the JAX package's.

``owned_geometries`` must deal the geometry table exactly as the
reference does; the dispatcher must own its slice and refuse the rest;
over a mesh of ``("cpu",) * n`` (n = 1, 2, 4: the port's counterpart of
forced host devices) every request is served exactly once, bit-equal to
the single-device engine at the per-shard bucket and identical across
device counts, and within 3e-4 of the JAX package's engine on the same
images and params.  The launcher's ``--cnn-dist`` entry exits 0 on the
CPU.
"""
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_parity import _clear_port_caches  # noqa: F401
from repro.serve.distributed import owned_geometries as ref_owned
from repro_torch.configs.serve import DIST_SMOKE
from repro_torch.dist import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models.cnn import params_from_numpy, tiny_cnn
from repro_torch.serve import (CnnServeEngine, ImageRequest, ServeRequest,
                               ShardedServeDispatcher, owned_geometries)

GEOMS = {(8, 8, 3): (2,), (12, 12, 3): (2,), (16, 16, 3): (1, 4)}
ROOT = Path(__file__).resolve().parents[1]


def _chain_params_numpy(params):
    return {"convs": [{k: np.asarray(v, np.float32) for k, v in p.items()}
                      for p in params["convs"]],
            "head": np.asarray(params["head"], np.float32)}


def _tiny():
    """The port's tiny_cnn with the JAX package's seed-0 params, and the
    reference model and params."""
    from repro.models.cnn import tiny_cnn as ref_tiny
    rm = ref_tiny()
    rp = rm.init(jax.random.PRNGKey(0))
    return tiny_cnn(), params_from_numpy(_chain_params_numpy(rp), "cpu"), \
        rm, rp


# ---------------------------------------------------------------------------
# deterministic per-host geometry ownership

@pytest.mark.parametrize("process_count", [1, 2, 3, 5])
def test_owned_geometries_equal_the_reference(process_count):
    parts = [owned_geometries(GEOMS, i, process_count)
             for i in range(process_count)]
    assert parts == [ref_owned(GEOMS, i, process_count)
                     for i in range(process_count)]
    combined = {}
    for p in parts:
        for shape, buckets in p.items():
            assert shape not in combined       # exactly one owner
            combined[shape] = buckets
    assert combined == {s: tuple(b) for s, b in GEOMS.items()}


def test_owned_geometries_refuses_a_bad_index():
    assert owned_geometries(GEOMS, 4, 5) == ref_owned(GEOMS, 4, 5) == {}
    with pytest.raises(ValueError, match="process_index"):
        owned_geometries(GEOMS, 3, 3)


def test_dispatcher_owns_its_slice_and_rejects_the_rest():
    model, params, _, _ = _tiny()
    disp = ShardedServeDispatcher(model, params, GEOMS, process_index=0,
                                  process_count=2, device="cpu")
    assert disp.owned == owned_geometries(GEOMS, 0, 2)
    unowned = next(s for s in GEOMS if s not in disp.owned)
    with pytest.raises(ValueError, match="not owned by process 0/2"):
        disp.submit(ServeRequest(rid=0, images=np.zeros(
            (1,) + unowned, np.float32)))
    idle = ShardedServeDispatcher(model, params, {(8, 8, 3): (2,)},
                                  process_index=1, process_count=2,
                                  device="cpu")
    assert idle.geometries == () and idle.frontend is None
    assert idle.poll() == [] and idle.run() == [] and idle.warmup() == {}
    assert idle.flush() == []
    st = idle.stats()
    assert st["requests"] == 0 and st["process_index"] == 1
    assert len(st["partitions"]) == idle.n_devices == 1


def test_process_index_and_count_come_from_rank_and_world_size(
        monkeypatch):
    model, params, _, _ = _tiny()
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "3")
    disp = ShardedServeDispatcher(model, params, GEOMS, device="cpu")
    assert (disp.process_index, disp.process_count) == (1, 3)
    assert disp.owned == owned_geometries(GEOMS, 1, 3)
    over = ShardedServeDispatcher(model, params, GEOMS, device="cpu",
                                  process_index=0, process_count=1)
    assert over.owned == {s: tuple(b) for s, b in GEOMS.items()}
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    plain = ShardedServeDispatcher(model, params, GEOMS, device="cpu")
    assert (plain.process_index, plain.process_count) == (0, 1)


# ---------------------------------------------------------------------------
# mesh and placement helpers

def test_serve_mesh_is_the_first_n_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.make_serve_mesh() == (torch.device("cuda", 0),
                                       torch.device("cuda", 1))
    assert tmesh.make_serve_mesh(1) == (torch.device("cuda", 0),)
    for bad in (3, -1):
        with pytest.raises(ValueError, match=r"n_devices must be in \[1, 2\]"):
            tmesh.make_serve_mesh(bad)
    assert tmesh.SERVE_AXIS == "data"


def test_params_are_replicated_once_and_pass_through():
    model, params, _, _ = _tiny()
    mesh = ("cpu",) * 3
    rep = sharding.replicate_params(params, mesh)
    assert isinstance(rep, sharding.Replicated) and len(rep) == 3
    assert all(copy is params for copy in rep)      # already there: no copy
    assert sharding.is_replicated_on(rep, mesh)
    assert not sharding.is_replicated_on(params, mesh)
    assert not sharding.is_replicated_on(rep, ("cpu",) * 2)
    assert sharding.replicate_params(rep, mesh) is rep
    assert sharding.replicated(mesh) == (torch.device("cpu"),) * 3
    assert sharding.batch_sharded(mesh, ndim=4) == sharding.replicated(mesh)
    with pytest.raises(ValueError, match="rank"):
        sharding.batch_sharded(mesh, ndim=0)
    # a tree on another device is copied to it
    meta = sharding.replicate_params(params, ("meta",))
    assert meta[0]["head"].device.type == "meta"
    assert meta[0]["convs"][0]["w"].shape == params["convs"][0]["w"].shape


# ---------------------------------------------------------------------------
# the device-count matrix

def _serve(n, model, params, imgs, shape, buckets):
    disp = ShardedServeDispatcher(model, params, {shape: buckets},
                                  mesh=("cpu",) * n, process_index=0,
                                  process_count=1, backend="cuda")
    assert disp.n_devices == n
    assert disp.global_buckets(shape) == tuple(b * n for b in buckets)
    progs = disp.frontend.programs[shape]
    assert progs.params is disp.params                  # replicated once
    disp.warmup()
    for i, x in enumerate(imgs):
        disp.submit(ServeRequest(rid=i, images=x))
    done = sorted(disp.run(), key=lambda r: r.rid)
    assert [r.rid for r in done] == list(range(len(imgs)))   # exactly once
    assert all(r.status == "served" for r in done)
    assert all(r.out.shape == (x.shape[0], 3) for r, x in zip(done, imgs))
    st = disp.stats()
    assert len(st["partitions"]) == n
    assert st["sharding"]["devices"] == n
    assert sum(st["sharding"]["per_device_units"]) == sum(
        x.shape[0] for x in imgs)
    assert st["devices"] == n
    return np.concatenate([r.out for r in done])


@pytest.mark.parametrize("shape", [s for s, _ in DIST_SMOKE.geometries])
def test_device_count_matrix_bitwise_identical_and_exactly_once(shape):
    """n = 1, 2, 4: the same request set served exactly once, bit-equal to
    the single-device engine at the per-shard bucket, identical across
    device counts, and within 3e-4 of the JAX package's engine."""
    from repro.serve.cnn import CnnServeEngine as RefEngine
    from repro.serve.cnn import ImageRequest as RefRequest
    model, params, rm, rp = _tiny()
    buckets = DIST_SMOKE.geometry_map()[shape]
    rng = np.random.default_rng(7)
    sizes = [1, 2, 3, 2] * 3                    # 12 requests, 24 images
    imgs = [rng.standard_normal((k,) + shape).astype(np.float32)
            for k in sizes]
    eng = CnnServeEngine(model, params, shape, buckets=buckets,
                         device="cpu", backend="cuda")
    for i, x in enumerate(imgs):
        eng.submit(ImageRequest(i, x))
    want = np.concatenate([r.out for r in eng.run()])
    digests = set()
    for n in (1, 2, 4):
        got = _serve(n, model, params, imgs, shape, buckets)
        np.testing.assert_array_equal(got, want, err_msg=f"devices={n}")
        digests.add(hashlib.sha1(got.tobytes()).hexdigest())
    assert len(digests) == 1
    ref = RefEngine(rm, rp, shape, buckets=buckets)
    for i, x in enumerate(imgs):
        ref.submit(RefRequest(i, x))
    ref_out = np.concatenate([np.asarray(r.out, np.float32)
                              for r in ref.run()])
    np.testing.assert_allclose(want, ref_out, rtol=0,
                               atol=3e-4 * np.abs(ref_out).max())


def test_sharded_batches_account_padding_to_the_trailing_devices():
    model, params, _, _ = _tiny()
    disp = ShardedServeDispatcher(model, params, {(8, 8, 3): (2,)},
                                  mesh=("cpu",) * 4, process_index=0,
                                  process_count=1)
    disp.warmup()
    disp.submit(ServeRequest(rid=0, images=np.ones((3, 8, 8, 3),
                                                    np.float32)))
    disp.run()
    (b,) = disp.frontend.telemetry.batches
    assert (b.bucket, b.units, list(b.shard_units)) == (8, 3, [2, 1, 0, 0])
    parts = disp.partitions()
    assert [p["units"] for p in parts] == [2, 1, 0, 0]
    assert [p["utilization"] for p in parts] == [1.0, 0.5, 0.0, 0.0]
    assert disp.stats()["sharding"]["max_shard_imbalance"] == 2


# ---------------------------------------------------------------------------
# the launcher

def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_launcher_cnn_dist_exits_zero_on_the_cpu():
    out = _launch("--cnn-dist", "--device", "cpu", "--requests", "6")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[serve-dist] process 0/1, 1 device(s)" in out.stdout
    st = json.loads(out.stdout[out.stdout.index("{"):])
    assert st["requests"] == st["served"] == 6
    assert st["deadline_misses"] == 0 and st["devices"] == 1
    assert set(st["global_buckets"]) == {"8x8x3", "12x12x3"}


def test_launcher_lm_exits_zero_on_the_cpu():
    out = _launch("--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                  "--requests", "2", "--max-new", "4", "--prompt-len", "8",
                  "--max-len", "16")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[serve] 2 requests, 8 tokens" in out.stdout


def test_chip_smoke_dispatcher_gate_expects_every_card(monkeypatch):
    """chip_smoke's frontend phase holds the dispatcher over
    ``make_serve_mesh()`` to one device for each card of the host: with
    four cards (``torch.cuda.device_count`` mocked) a dispatcher that
    reports 4 devices passes and one that reports 1 fails, as does one
    whose requests differ from the plain frontend's; the dispatcher is
    scaled over 1, 2 and 4 cards there, and over 1 on one card."""
    from _torch_parity import chip_smoke
    cs = chip_smoke()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cs.check_dispatcher({"devices": 4}, True)
    for stats, same in (({"devices": 1}, True), ({"devices": 4}, False)):
        with pytest.raises(SystemExit):
            cs.check_dispatcher(stats, same)
    assert cs.scaling_counts(torch.cuda.device_count()) == [1, 2, 4]
    assert cs.scaling_counts(1) == [1]
    assert cs.scaling_counts(3) == [1, 2, 3]
