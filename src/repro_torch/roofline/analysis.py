"""Three-term roofline from the dry-run records, with the H100's peaks:
the JAX package's ``roofline/analysis.py``.

  compute term    = FLOPs / peak bf16 FLOP/s                  [per card]
  memory term     = bytes / HBM bandwidth                     [per card]
  collective term = collective bytes / the link's bandwidth   [per card]

FLOPs, bytes and collective bytes are one rank's, counted on meta by
``launch/dryrun.py`` and extrapolated from its 1- and 2-period probes to
the full depth.  The bytes are the eager step's: every local op's inputs
and outputs, nothing fused, so the memory term is the unfused step's.
MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens
(inference), the "useful" compute; its ratio to the counted FLOPs
exposes recompute and redundancy.

``HW`` holds NVIDIA's published figures for the H100 SXM, not
measurements: 989 TFLOP/s dense bf16, 3.35 TB/s of HBM3, NVLink 4 at
450 GB/s a direction per GPU inside an 8-GPU node, and 50 GB/s per GPU
between nodes (one 400 Gb/s NDR port per GPU, as in a DGX H100).

The collective term charges each collective at the rate of the slowest
link its mesh axis crosses.  Ranks are laid out with the last mesh axis
fastest, eight to a node, so an axis crosses nodes when its stride times
its size exceeds eight.  The counter does not record which axis each
collective ran on, so the term takes the slowest link that any axis of
size > 1 crosses.  On (16, 16) and (2, 16, 16), with 'model' fastest,
every axis spans nodes (16 ranks of 'model' fill two nodes), so the
whole term runs at the inter-node rate.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "NVIDIA H100 SXM (published peaks)"
    peak_flops: float = 989e12          # dense bf16 FLOP/s per GPU
    hbm_bw: float = 3.35e12             # HBM3 B/s per GPU
    nvlink_bw: float = 450e9            # NVLink 4, B/s a direction per GPU
    internode_bw: float = 50e9          # one 400 Gb/s NDR port per GPU
    gpus_per_node: int = 8

    def link_bw(self, mesh: str) -> float:
        """The bandwidth of the slowest link that any axis of ``mesh``
        ("16x16", "2x16x16") of size > 1 crosses, the last axis
        fastest."""
        dims = [int(n) for n in mesh.split("x")]
        crosses = [n > 1 and math.prod(dims[i:]) > self.gpus_per_node
                   for i, n in enumerate(dims)]
        return self.internode_bw if any(crosses) else self.nvlink_bw


HW = Hardware()

#: what to pull, per dominant term: the port's own levers on the H100
LEVERS = {
    "compute": ("the residual after each mixer is a partial sum over "
                "'model' (its wo leaves it so), and torch 2.13's DTensor "
                "then runs the MLP's products with their weights whole on "
                "every 'model' rank; reduce it there and they split; "
                "heads padded where 'model' does not divide them; remat "
                "'dots' in place of 'full'"),
    "memory": ("ce_impl=chunked (the simple loss holds fp32 logits whole "
               "over the vocab, twice: the logsumexp and shard_local's "
               "gather); fused kernels for the eager step's elementwise "
               "passes; stat_f32 norms and bf16 rope"),
    "collective": ("the whole-tensor gathers of shard_local (the embedding "
                   "table, the logits' vocab, the attention heads), "
                   "sequence-sharded residuals (--act-seq-shard), bf16 "
                   "collectives"),
}


def analyze_record(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "OK":
        return None
    probe = rec.get("probe", {})
    flops = probe.get("flops_total_per_device")
    byts = probe.get("bytes_total_per_device")
    coll = probe.get("collective_bytes_total_per_device")
    if flops is None:
        flops = rec.get("flops_per_device")
        byts = rec.get("bytes_accessed_per_device")
        coll = rec.get("collective_bytes_per_device")
    t_c = flops / HW.peak_flops
    t_m = byts / HW.hbm_bw
    t_x = coll / HW.link_bw(rec["mesh"])
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    dom = max(terms, key=terms.get)
    mult = 6 if rec["kind"] == "train" else 2
    model_flops = mult * rec["active_params"] * rec["tokens"]
    counted_global = flops * rec["devices"]
    bound_time = max(terms.values())
    # roofline fraction: useful model flops over the time the dominant
    # term pins the step at, vs the card's peak
    frac = (model_flops / rec["devices"] / bound_time) / HW.peak_flops
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "dominant": dom, "model_flops": model_flops,
        "hlo_flops_global": counted_global,
        "useful_ratio": (model_flops / counted_global if counted_global
                         else 0.0),
        "roofline_frac": frac,
        "peak_gib": rec["memory"]["peak_bytes"] / 2**30,
        "lever": LEVERS[dom],
    }


def analyze_all(art_dir="artifacts/dryrun_torch") -> List[Dict]:
    out = []
    for f in sorted(Path(art_dir).glob("*.json")):
        rec = json.loads(f.read_text())
        row = analyze_record(rec)
        if row is None:
            row = {"arch": rec["arch"], "shape": rec["shape"],
                   "mesh": rec["mesh"], "status": rec["status"]}
        else:
            row["status"] = "OK"
        row["variant"] = rec.get("variant", "")
        out.append(row)
    return out


def to_markdown(rows: List[Dict], mesh: str = "16x16") -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | bound | "
           "6ND/counted | roofline frac | peak GiB |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if r.get("mesh") != mesh or r.get("variant"):
            continue
        if r["status"] != "OK":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"{r['status']} | — | — | — |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_frac']:.3f} | {r['peak_gib']:.1f} |")
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default="artifacts/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    rows = analyze_all(args.art)
    print(to_markdown(rows, args.mesh))


if __name__ == "__main__":
    main()
