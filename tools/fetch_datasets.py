"""Benchmark-dataset fetcher — parity with the reference's dataset
Makefiles (``dataset/large/*/Makefile`` + ``common.mk``: one
``GRAPH_URL`` per directory, ``wget -N`` + untar, reference
``dataset/large/ak2010/Makefile:1-5``).

    python tools/fetch_datasets.py soc-orkut road_usa
    python tools/fetch_datasets.py --list
    python tools/fetch_datasets.py --synth road_usa   # offline stand-in

Each dataset lands in ``<out>/<name>/<name>.mtx`` ready for
``gunrock_jax.io.load_market`` / the CLI's ``market:`` graph kind.

Offline environments (no egress): ``--synth`` writes a generator-backed
stand-in with the real dataset's published V/E scale and family —
rgg for road/osm meshes, R-MAT for the social/web graphs — so perf
matrices keep a row per reference dataset class without network access.
"""

from __future__ import annotations

import argparse
import os
import sys
import tarfile
import urllib.request
import zipfile

# name -> (url, family, num_vertices, num_edges_directed)
# Scale figures are the published SuiteSparse/NR values the reference's
# result tables cite (doc/stats/engines_topc.md).
DATASETS = {
    "ak2010": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/ak2010.tar.gz", "mesh", 45292, 217098),
    "arabic-2005": ("http://www.cise.ufl.edu/research/sparse/MM/LAW/arabic-2005.tar.gz", "web", 22744080, 639999458),
    "asia_osm": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/asia_osm.tar.gz", "road", 11950757, 25423206),
    "belgium_osm": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/belgium_osm.tar.gz", "road", 1441295, 3099940),
    "cit-Patents": ("http://www.cise.ufl.edu/research/sparse/MM/SNAP/cit-Patents.tar.gz", "social", 3774768, 16518948),
    "coAuthorsDBLP": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/coAuthorsDBLP.tar.gz", "social", 299067, 1955352),
    "delaunay_n13": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/delaunay_n13.tar.gz", "mesh", 8192, 49094),
    "delaunay_n21": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/delaunay_n21.tar.gz", "mesh", 2097152, 12582816),
    "delaunay_n24": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/delaunay_n24.tar.gz", "mesh", 16777216, 100663202),
    "europe_osm": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/europe_osm.tar.gz", "road", 50912018, 108109320),
    "germany_osm": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/germany_osm.tar.gz", "road", 11548845, 24738362),
    "hollywood-2009": ("http://www.cise.ufl.edu/research/sparse/MM/LAW/hollywood-2009.tar.gz", "social", 1139905, 113891327),
    "indochina-2004": ("http://www.cise.ufl.edu/research/sparse/MM/LAW/indochina-2004.tar.gz", "web", 7414866, 194109311),
    "kron_g500-logn21": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/kron_g500-logn21.tar.gz", "social", 2097152, 182082942),
    "rgg_n_2_24_s0": (None, "road", 16777216, 265114400),
    "roadNet-CA": ("http://www.cise.ufl.edu/research/sparse/MM/SNAP/roadNet-CA.tar.gz", "road", 1971281, 5533214),
    "road_central": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/road_central.tar.gz", "road", 14081816, 33866826),
    "road_usa": ("http://www.cise.ufl.edu/research/sparse/MM/DIMACS10/road_usa.tar.gz", "road", 23947347, 57708624),
    "soc-LiveJournal1": ("http://www.cise.ufl.edu/research/sparse/MM/SNAP/soc-LiveJournal1.tar.gz", "social", 4847571, 68993773),
    "soc-orkut": ("http://nrvis.com/download/data/soc/soc-orkut.zip", "social", 2997166, 212698418),
    "soc-sinaweibo": ("http://nrvis.com/download/data/massive/soc-sinaweibo.zip", "social", 58655849, 522642066),
    "soc-twitter-2010": ("http://nrvis.com/download/data/massive/soc-twitter-2010.zip", "social", 21297772, 530051090),
    "uk-2002": ("http://www.cise.ufl.edu/research/sparse/MM/LAW/uk-2002.tar.gz", "web", 18520486, 298113762),
    "uk-2005": ("http://www.cise.ufl.edu/research/sparse/MM/LAW/uk-2005.tar.gz", "web", 39459925, 936364282),
    "webbase-1M": ("http://www.cise.ufl.edu/research/sparse/MM/Williams/webbase-1M.tar.gz", "web", 1000005, 3105536),
    "webbase-2001": ("http://www.cise.ufl.edu/research/sparse/MM/LAW/webbase-2001.tar.gz", "web", 118142155, 1019903190),
}


def fetch(name: str, out_dir: str) -> str:
    url, _, _, _ = DATASETS[name]
    if url is None:
        raise SystemExit(f"{name} has no upstream URL in the reference "
                         "either (generated): use --synth")
    dest = os.path.join(out_dir, name)
    os.makedirs(dest, exist_ok=True)
    archive = os.path.join(dest, os.path.basename(url))
    if not os.path.exists(archive):
        print(f"fetching {url}", file=sys.stderr)
        urllib.request.urlretrieve(url, archive)  # common.mk `wget -N`
    if archive.endswith(".tar.gz"):
        with tarfile.open(archive) as t:
            t.extractall(dest, filter="data")
    elif archive.endswith(".zip"):
        with zipfile.ZipFile(archive) as z:
            z.extractall(dest)
    # normalize to <dest>/<name>.mtx like the Makefiles' `setup` target
    for root, _, files in os.walk(dest):
        for f in files:
            if f.endswith(".mtx") and f != f"{name}.mtx":
                os.replace(os.path.join(root, f),
                           os.path.join(dest, f"{name}.mtx"))
    return os.path.join(dest, f"{name}.mtx")


def _write_market(g, path: str) -> None:
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n")
        f.write(f"{g.num_nodes} {g.num_nodes} {g.num_edges}\n")
        import numpy as np
        dst = np.asarray(g.col_indices)
        src = np.repeat(np.arange(g.num_nodes),
                        np.diff(np.asarray(g.row_offsets)))
        np.savetxt(f, np.column_stack([src + 1, dst + 1]), fmt="%d")


def synthesize(name: str, out_dir: str) -> str:
    """Generator-backed offline stand-in at the dataset's published
    scale: rgg for road/mesh families, R-MAT for social/web."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import math

    from gunrock_jax.io import generators
    _, family, v, e = DATASETS[name]
    dest = os.path.join(out_dir, name)
    os.makedirs(dest, exist_ok=True)
    path = os.path.join(dest, f"{name}.synth.mtx")
    if family in ("road", "mesh"):
        n = min(v, 1 << 22)                       # host-memory bound
        g = generators.rgg(n, 0.55 * math.sqrt(math.log(n) / n), seed=1)
    else:
        scale = min(int(math.ceil(math.log2(max(v, 2)))), 22)
        ef = max(1, min(e // v, 32))
        g = generators.rmat(scale=scale, edge_factor=ef, seed=1,
                            undirected=True)
    _write_market(g, path)
    print(f"synthesized {name} stand-in ({family}, V={g.num_nodes}, "
          f"E={g.num_edges}) -> {path}", file=sys.stderr)
    return path


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("names", nargs="*", help="dataset names (see --list)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="dataset/large")
    ap.add_argument("--synth", action="store_true",
                    help="offline generator stand-in (no network)")
    args = ap.parse_args()
    if args.list or not args.names:
        for n, (url, fam, v, e) in DATASETS.items():
            print(f"{n:24s} {fam:7s} V={v:>12,} E={e:>14,}")
        return
    for n in args.names:
        if n not in DATASETS:
            raise SystemExit(f"unknown dataset {n!r} (see --list)")
        print(synthesize(n, args.out) if args.synth
              else fetch(n, args.out))


if __name__ == "__main__":
    main()
