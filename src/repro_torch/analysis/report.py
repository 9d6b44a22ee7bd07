"""Tables from the dry-run's records (``experiments/dryrun_torch/*.json``,
``launch/dryrun.py``), as the reference's ``repro/analysis/report.py``
renders its own: the roofline table, and a cell's collectives op by op
from the record's own list (the reference walks HLO for it)."""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def load_records(mesh: str = "single", tag: str = "",
                 root: Path = DRYRUN_DIR) -> List[dict]:
    recs = []
    suffix = f"_{mesh}" + (f"_{tag}" if tag else "") + ".json"
    for p in sorted(Path(root).glob(f"*{suffix}")):
        if tag == "" and re.search(r"_(single|multi)_[^.]+\.json$", p.name):
            continue                      # skip tagged variants
        recs.append(json.loads(p.read_text()))
    return recs


def roofline_table(recs: List[dict]) -> str:
    """The reference's columns (the terms from the counted flops of one
    rank, on an H100) plus the peak a rank needs and whether it fits an
    80 GB card."""
    rows = ["| arch | shape | bound | compute s | memory s | collective s | "
            "useful FLOP ratio | HBM/chip GB | fits 80 GB |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if "skipped" in r or "error" in r:
            what = "skipped" if "skipped" in r else "ERROR"
            rows.append(f"| {r['arch']} | {r['shape']} | {what} | — | — | "
                        f"— | — | — | — |")
            continue
        t = r["roofline"]
        ur = r.get("useful_flop_ratio")
        rows.append(
            f"| {r['arch']} | {r['shape']} | **{t['bound']}** | "
            f"{t['compute_s']:.4f} | {t['memory_s']:.4f} | "
            f"{t['collective_s']:.4f} | "
            f"{f'{ur:.3f}' if ur else '—'} | {r['hbm_per_chip_gb']} | "
            f"{'yes' if r['fits_80gb'] else 'no'} |")
    return "\n".join(rows)


def collective_breakdown(rec: dict, top: int = 20) -> List[dict]:
    """A record's collectives, largest first: each op's kind, bytes a
    rank, group size, dtype and the shape of the tensor it moves."""
    ops = sorted(rec.get("collectives", {}).get("ops", []),
                 key=lambda o: -o["bytes"])
    return ops[:top]


def collective_table(rec: dict, top: int = 20) -> str:
    rows = ["| op | bytes | group | dtype | shape |", "|---|---|---|---|---|"]
    for o in collective_breakdown(rec, top):
        rows.append(f"| {o['op']} | {o['bytes']} | {o['group']} | "
                    f"{o['dtype']} | {tuple(o['shape'])} |")
    return "\n".join(rows)
