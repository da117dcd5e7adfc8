"""The port's roofline (``repro_torch.roofline``) against the JAX
package's ``roofline/analysis.py``: the same record through both, the
reference's TPU constants swapped for the port's H100 figures in the
test alone."""
import json

import pytest

from repro.roofline import analysis as janalysis
from repro_torch.roofline import HW, analyze_all
from repro_torch.roofline import analysis as A


def _record(arch="qwen2-1.5b", shape="train_4k", mesh="16x16", kind="train",
            probe=True, variant=""):
    rec = {"arch": arch, "shape": shape, "variant": variant, "mesh": mesh,
           "status": "OK", "devices": 512 if mesh == "2x16x16" else 256,
           "flops_per_device": 1.5e13, "bytes_accessed_per_device": 7.5e11,
           "collectives": {"all-gather": {"count": 3, "bytes": 4e9}},
           "collective_bytes_per_device": 4e9,
           "memory": {"argument_bytes": 2**30, "output_bytes": 2**30,
                      "temp_bytes": 3 * 2**30, "peak_bytes": 4 * 2**30},
           "params": 1_543_910_912, "active_params": 1_543_910_912,
           "tokens": 256 * 4096 if kind != "decode" else 128, "kind": kind}
    if probe:
        rec["probe"] = {"period": 1, "n_periods": 28,
                        "flops_total_per_device": 2.5e14,
                        "bytes_total_per_device": 5.3e12,
                        "collective_bytes_total_per_device": 2.2e11}
    return rec


def test_hw_is_nvidias_published_h100_sxm():
    assert "H100" in HW.name and "published" in HW.name
    assert (HW.peak_flops, HW.hbm_bw, HW.nvlink_bw, HW.internode_bw,
            HW.gpus_per_node) == (989e12, 3.35e12, 450e9, 50e9, 8)


@pytest.mark.parametrize("mesh, rate", [
    ("16x16", 50e9), ("2x16x16", 50e9), ("1x8", 450e9), ("2x4", 450e9),
    ("1x1", 450e9), ("4x4", 50e9), ("1x16", 50e9)])
def test_the_collective_term_takes_the_slowest_link_crossed(mesh, rate):
    """The last axis fastest, 8 GPUs a node: an axis crosses nodes when
    its stride times its size exceeds 8; the production meshes cross
    them on every axis."""
    assert HW.link_bw(mesh) == rate


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("probe", [True, False])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_analyze_record_is_the_references_with_the_h100s_figures(
        kind, probe, mesh, monkeypatch):
    """The reference's analyze_record with its HW swapped for the port's
    figures (its one link rate the inter-node one, which the production
    meshes take) gives every number the port's gives; the levers are
    the port's own."""
    monkeypatch.setattr(janalysis, "HW", janalysis.Hardware(
        name=HW.name, peak_flops=HW.peak_flops, hbm_bw=HW.hbm_bw,
        ici_bw=HW.link_bw(mesh)))
    rec = _record(kind=kind, probe=probe, mesh=mesh)
    got, want = A.analyze_record(rec), janalysis.analyze_record(rec)
    assert set(got) == set(want)
    for k in got:
        if k != "lever":
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["lever"] == A.LEVERS[got["dominant"]]
    assert A.analyze_record(dict(rec, status="FAIL: x")) is None


def test_analyze_all_reads_records_of_both_packages(tmp_path):
    """A directory holding a record of each package (the reference's from
    ``artifacts/dryrun``, the port's from ``artifacts/dryrun_torch``), a
    SKIP and a variant: one row each, in file order."""
    recs = {"a__train_4k__pod.json": _record(arch="a"),
            "b__train_4k__pod.json": dict(_record(arch="b"),
                                          compile_s=12.5),
            "c__long_500k__pod.json": {"arch": "c", "shape": "long_500k",
                                       "mesh": "16x16", "variant": "",
                                       "status": "SKIP(full-attn)"},
            "d__train_4k__pod__v.json": _record(arch="d", variant="v")}
    for name, rec in recs.items():
        (tmp_path / name).write_text(json.dumps(rec))
    rows = analyze_all(tmp_path)
    assert [r["arch"] for r in rows] == ["a", "b", "c", "d"]
    assert [r["status"] for r in rows] == ["OK", "OK", "SKIP(full-attn)",
                                           "OK"]
    assert rows[3]["variant"] == "v" and rows[0]["variant"] == ""
    assert rows[0]["dominant"] == "collective"
    assert rows[0]["collective_s"] == pytest.approx(2.2e11 / 50e9)


def test_to_markdown_lists_one_mesh_without_variants(tmp_path):
    rows = [dict(A.analyze_record(_record()), status="OK", variant=""),
            dict(A.analyze_record(_record(arch="v")), status="OK",
                 variant="x"),
            dict(A.analyze_record(_record(arch="m", mesh="2x16x16")),
                 status="OK", variant=""),
            {"arch": "s", "shape": "long_500k", "mesh": "16x16",
             "status": "SKIP(full-attn)", "variant": ""}]
    md = A.to_markdown(rows)
    lines = md.strip().splitlines()
    assert lines[0].startswith("| arch | shape | compute s")
    assert len(lines) == 4
    assert lines[2].startswith("| qwen2-1.5b | train_4k | 0.253 | 1.582 | "
                               "4.400 | **collective** |")
    assert lines[3] == "| s | long_500k | — | — | — | SKIP(full-attn) | " \
                       "— | — | — |"
    assert "| m |" in A.to_markdown(rows, mesh="2x16x16")


def test_the_cli_prints_the_table(tmp_path, capsys):
    (tmp_path / "r.json").write_text(json.dumps(_record()))
    A.main(["--art", str(tmp_path)])
    assert "| qwen2-1.5b | train_4k |" in capsys.readouterr().out
