"""Host-ingest throughput artifact: native parser vs Python fallback.

docs/performance.md claims the native C++ loader (zlib inflate + tokenizer
thread pool, ``_native/beagle_reader.cpp``) beats the pure-Python reader
and scales with threads, but round 4 committed no rows/s / MB/s number
(VERDICT r4 missing #4 / next #7).  This benchmark measures, on a
>= 1M-row slice of the cached headline Beagle.gz:

  * native parse at 1, 2, and all host threads — rows/s and effective
    decompressed-text MB/s,
  * the pure-Python fallback (on a smaller slice, extrapolation-free: its
    own rows/s is reported at its own slice size),
  * the streamed skip path (decompress + line-count only — the multi-host
    "rows before my window" cost),
  * the native allele-depth int reader vs np.loadtxt.

The reference baseline for this component is reader_cy.pyx:16-77
(`gunzip -c` subprocess + single-threaded strtok/atof) — the Python
fallback row is the closest in-repo stand-in for that single-threaded
text scan.

Prints one JSON line.

Usage:
  python benchmarks/parser_throughput_bench.py [--rows 1000000]
      [--beagle /tmp/wgsa_headline/headline.beagle.gz]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def row_bytes(path: str) -> float:
    """Mean decompressed bytes per data row (sampled from the head)."""
    with gzip.open(path, "rb") as f:
        f.readline()
        total = 0
        for i in range(200):
            line = f.readline()
            if not line:
                return total / max(i, 1)
            total += len(line)
    return total / 200


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--beagle", default="/tmp/wgsa_headline/headline.beagle.gz")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--py_rows", type=int, default=100_000)
    ap.add_argument("--ad_rows", type=int, default=400_000)
    ap.add_argument("--ad_cols", type=int, default=64)
    args = ap.parse_args()

    import numpy as np

    from wgsassign_jax._native import (
        open_beagle_stream,
        read_beagle_native,
        read_int_matrix_native,
    )
    from wgsassign_jax.io.beagle import _read_beagle_python

    if not os.path.exists(args.beagle):
        from wgsassign_jax.io.synth import synth_beagle_file

        args.beagle = "/tmp/wgsa_parser_bench.beagle.gz"
        if not os.path.exists(args.beagle):
            synth_beagle_file(args.beagle, args.rows, 180, seed=0)

    rb = row_bytes(args.beagle)
    all_threads = max(os.cpu_count() or 1, 1)

    native = {}
    for nt in sorted({1, 2, all_threads}):
        t0 = time.perf_counter()
        d = read_beagle_native(
            args.beagle, n_threads=nt, row_range=(0, args.rows)
        )
        dt = time.perf_counter() - t0
        rows = d.gl.shape[0]
        native[str(nt)] = {
            "rows": rows,
            "seconds": round(dt, 2),
            "rows_per_s": round(rows / dt),
            "text_mb_per_s": round(rows * rb / dt / 1e6, 1),
        }

    t0 = time.perf_counter()
    dpy = _read_beagle_python(args.beagle, row_range=(0, args.py_rows))
    dt_py = time.perf_counter() - t0
    py = {
        "rows": dpy.gl.shape[0],
        "seconds": round(dt_py, 2),
        "rows_per_s": round(dpy.gl.shape[0] / dt_py),
        "text_mb_per_s": round(dpy.gl.shape[0] * rb / dt_py / 1e6, 1),
    }

    # streamed skip: decompress + line-count only (multi-host pre-window)
    with open_beagle_stream(args.beagle, n_threads=all_threads) as st:
        t0 = time.perf_counter()
        skipped = st.skip_rows(args.rows)
        dt_skip = time.perf_counter() - t0
    skip = {
        "rows": skipped,
        "seconds": round(dt_skip, 2),
        "rows_per_s": round(skipped / dt_skip),
        "text_mb_per_s": round(skipped * rb / dt_skip / 1e6, 1),
    }

    # allele-depth int matrix: native tokenizer vs np.loadtxt
    rng = np.random.default_rng(0)
    ad = rng.integers(0, 40, size=(args.ad_rows, args.ad_cols))
    ad_path = "/tmp/wgsa_parser_bench_ad.txt"
    if not os.path.exists(ad_path):
        np.savetxt(ad_path, ad, fmt="%d", delimiter="\t")
    read_int_matrix_native(ad_path)  # warm the lazy .so build
    t0 = time.perf_counter()
    read_int_matrix_native(ad_path)
    dt_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.loadtxt(ad_path, dtype=np.int32)
    dt_ltx = time.perf_counter() - t0
    vals = args.ad_rows * args.ad_cols
    ad_row = {
        "values": vals,
        "native_mvals_per_s": round(vals / dt_nat / 1e6, 1),
        "loadtxt_mvals_per_s": round(vals / dt_ltx / 1e6, 1),
        "speedup": round(dt_ltx / dt_nat, 2),
    }

    print(json.dumps({
        "metric": "host_ingest_throughput",
        "beagle": args.beagle,
        "bytes_per_row": round(rb, 1),
        "host_threads": all_threads,
        "native_by_threads": native,
        "python_fallback": py,
        "native_vs_python_speedup": round(
            native[str(all_threads)]["rows_per_s"] / py["rows_per_s"], 1
        ),
        "stream_skip": skip,
        "allele_depth_int_reader": ad_row,
    }), flush=True)


if __name__ == "__main__":
    main()
