"""Render the roofline table from the dry-run's records, and a cell's
collectives:

    PYTHONPATH=src python -m repro_torch.analysis [--mesh single|multi] [--tag opt]
    PYTHONPATH=src python -m repro_torch.analysis --collectives llama3.2-1b train_4k
"""
import argparse

from .report import collective_table, load_records, roofline_table


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="")
    ap.add_argument("--collectives", nargs=2, metavar=("ARCH", "SHAPE"),
                    help="the collectives of one cell, largest first")
    args = ap.parse_args(argv)
    recs = load_records(args.mesh, args.tag)
    if args.collectives:
        arch, shape = args.collectives
        rec = next((r for r in recs if (r["arch"], r["shape"]) ==
                    (arch, shape)), None)
        if rec is None:
            raise SystemExit(f"no record of {arch} x {shape} "
                             f"(mesh {args.mesh})")
        print(f"## Collectives — {arch} x {shape}, mesh {rec['mesh']}\n")
        print(collective_table(rec))
        return
    print(f"## Roofline — mesh={args.mesh} tag={args.tag or 'baseline'} "
          f"({len(recs)} cells, one rank of the port, NVIDIA H100)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
