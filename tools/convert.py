"""Graph format converters — parity with the reference's ``tools/``
(mtx<->gr/binary converters, weight add/remove/replace scripts).

    python tools/convert.py mtx2bin in.mtx out.csr.npz [--undirected]
    python tools/convert.py bin2mtx in.csr.npz out.mtx
    python tools/convert.py add-weights in.csr.npz out.csr.npz --seed 1
    python tools/convert.py strip-weights in.csr.npz out.csr.npz
    python tools/convert.py info graph.{mtx,csr.npz}
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gunrock_jax.graph.csr import CsrGraph            # noqa: E402
from gunrock_jax.io.market import load_market         # noqa: E402


def _load(path: str, undirected: bool) -> CsrGraph:
    if path.endswith((".npz",)):
        return CsrGraph.read_binary(path)
    return load_market(path, undirected=undirected or None, use_cache=False)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="convert")
    p.add_argument("cmd", choices=("mtx2bin", "bin2mtx", "add-weights",
                                   "strip-weights", "info"))
    p.add_argument("src")
    p.add_argument("dst", nargs="?")
    p.add_argument("--undirected", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lo", type=float, default=0.0)
    p.add_argument("--hi", type=float, default=64.0)
    args = p.parse_args(argv)

    g = _load(args.src, args.undirected)

    if args.cmd == "info":
        deg = g.out_degrees
        print(f"|V|={g.num_nodes} |E|={g.num_edges} "
              f"weighted={g.edge_values is not None} "
              f"undirected={g.undirected}")
        print(f"degree: min={deg.min(initial=0)} max={deg.max(initial=0)} "
              f"mean={deg.mean() if len(deg) else 0:.2f}")
        print("histogram(log2):", g.degree_histogram().tolist())
        return 0

    if not args.dst:
        p.error(f"{args.cmd} needs a destination path")

    if args.cmd == "mtx2bin":
        g.write_binary(args.dst)
    elif args.cmd == "bin2mtx":
        src_ids = g.edge_sources()
        with open(args.dst, "w") as f:
            kind = "real" if g.edge_values is not None else "pattern"
            f.write(f"%%MatrixMarket matrix coordinate {kind} general\n")
            f.write(f"{g.num_nodes} {g.num_nodes} {g.num_edges}\n")
            if g.edge_values is not None:
                for s, d, w in zip(src_ids, g.col_indices, g.edge_values):
                    f.write(f"{s + 1} {d + 1} {w}\n")
            else:
                for s, d in zip(src_ids, g.col_indices):
                    f.write(f"{s + 1} {d + 1}\n")
    elif args.cmd == "add-weights":
        g.random_edge_values(args.lo, args.hi, seed=args.seed)
        g.write_binary(args.dst)
    elif args.cmd == "strip-weights":
        g.edge_values = None
        g.write_binary(args.dst)
    print(f"wrote {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
