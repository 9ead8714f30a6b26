"""Roofline report generator: reads dry-run artifacts and emits the
§Dry-run and §Roofline markdown tables.

  PYTHONPATH=src python -m repro_torch.launch.roofline \
      [--dir experiments/dryrun_torch/16x16]

A copy of ``repro.launch.roofline`` for the H100 (``launch/hardware.py``):
the headers name the card's 80 GB and constants, and the compute-bound
advice its tensor cores. It reads either package's artifacts (the same
keys).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.config import SHAPES
from repro_torch.configs import ARCH_IDS

SHAPE_ORDER = list(SHAPES)


def _advice(art: Dict) -> str:
    """One sentence on what would move the dominant term down."""
    dom = art["dominant"]
    probes = art.get("probe", {}).get("probes", {})
    colls = art.get("collectives", {})
    if dom == "collective_s":
        big = max(colls, key=lambda k: colls[k]["bytes"]) if colls else "?"
        if big == "all-gather":
            return ("dominated by parameter all-gathers (FSDP weight-"
                    "gathering): overlap gathers with compute across layers, "
                    "or trade FSDP degree for TP/replication")
        if big == "all-reduce":
            return ("dominated by gradient all-reduce: switch to reduce-"
                    "scatter + gather (ZeRO-2 flow), int8 compression, or "
                    "larger microbatches to amortise")
        return f"dominated by {big}: rework sharding to localise that operand"
    if dom == "memory_s":
        head = probes.get("head", {}).get("bytes", 0) * \
            art.get("probe", {}).get("scale", {}).get("head", 1)
        total = art.get("probe", {}).get("bytes", 1)
        if head > 0.4 * max(total, 1):
            return ("logits/CE dominate HBM traffic: chunk the vocab in the "
                    "loss (streaming logsumexp) so full logits never hit HBM")
        return ("HBM-bound in the layer stack: fuse elementwise chains, "
                "bf16 intermediates, bigger arithmetic-intensity tiles")
    return ("compute-bound (good): push tensor-core utilisation via larger "
            "tiles / fewer transposes; remaining headroom is remat recompute")


def load(art_dir: str) -> List[Dict]:
    arts = []
    for p in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(p) as f:
            arts.append(json.load(f))
    return arts


def dryrun_table(arts: List[Dict]) -> str:
    lines = ["| arch | shape | status | compile s | live GiB/dev | fits 80G |"
             " collective ops/step (AG/AR/RS/A2A/CP) |",
             "|---|---|---|---|---|---|---|"]
    order = {a: i for i, a in enumerate(ARCH_IDS)}
    arts = sorted(arts, key=lambda a: (order.get(a["arch"], 99),
                                       SHAPE_ORDER.index(a["shape"])))
    for a in arts:
        if a["status"] == "ok":
            c = a.get("collectives", {})
            def n(k):
                return int(c.get(k, {}).get("count", 0))
            counts = (f"{n('all-gather')}/{n('all-reduce')}/"
                      f"{n('reduce-scatter')}/{n('all-to-all')}/"
                      f"{n('collective-permute')}")
            lines.append(
                f"| {a['arch']} | {a['shape']} | ok | {a['compile_s']:.0f} "
                f"| {a['live_bytes_per_dev']/2**30:.2f} "
                f"| {'yes' if a['fits_hbm'] else 'NO'} | {counts} |")
        elif a["status"] == "skipped":
            lines.append(f"| {a['arch']} | {a['shape']} | skip (design) "
                         f"| — | — | — | — |")
        else:
            lines.append(f"| {a['arch']} | {a['shape']} | ERROR | — | — | — "
                         f"| {a.get('error','')[:60]} |")
    return "\n".join(lines)


def roofline_table(arts: List[Dict]) -> str:
    lines = ["| arch | shape | compute ms | memory ms | collective ms | "
             "dominant | useful-FLOPs ratio | roofline frac | "
             "what moves the dominant term |",
             "|---|---|---|---|---|---|---|---|---|"]
    order = {a: i for i, a in enumerate(ARCH_IDS)}
    arts = sorted(arts, key=lambda a: (order.get(a["arch"], 99),
                                       SHAPE_ORDER.index(a["shape"])))
    for a in arts:
        if a["status"] != "ok":
            continue
        t = a["roofline"]
        ratio = a.get("useful_flops_ratio")
        frac = a.get("roofline_fraction")
        lines.append(
            f"| {a['arch']} | {a['shape']} "
            f"| {t['compute_s']*1e3:.1f} | {t['memory_s']*1e3:.1f} "
            f"| {t['collective_s']*1e3:.1f} | {a['dominant'][:-2]} "
            f"| {ratio:.2f} | {frac:.3f} | {_advice(a)} |")
    return "\n".join(lines)


def pick_hillclimb(arts: List[Dict]) -> Dict[str, Dict]:
    ok = [a for a in arts if a["status"] == "ok"]
    worst = min(ok, key=lambda a: a.get("roofline_fraction") or 1)
    coll = max(ok, key=lambda a: a["roofline"]["collective_s"] /
               max(sum(a["roofline"][k] for k in
                       ("compute_s", "memory_s", "collective_s")), 1e-12))
    return {"worst_roofline": worst, "most_collective_bound": coll}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "../../../experiments/dryrun_torch/16x16"))
    args = ap.parse_args(argv)
    arts = load(args.dir)
    print("## Dry-run (single-pod 16x16 = 256 H100s)\n")
    print(dryrun_table(arts))
    print("\n## Roofline (per-device, per-step, H100 constants)\n")
    print(roofline_table(arts))
    picks = pick_hillclimb(arts)
    print("\nhillclimb candidates:")
    for why, a in picks.items():
        print(f"  {why}: {a['arch']} / {a['shape']} "
              f"(frac={a.get('roofline_fraction'):.4f}, dom={a['dominant']})")


if __name__ == "__main__":
    main()
