"""At-scale z-score benchmark: both modes, full cohort width.

Round 4's only at-scale z number was reference mode at 2M sites x 8
individuals; assignment mode had none, and the serial host passes
(``_prepare_tables`` building per-individual combo tables;
``_gl_column_iter`` D2H-gathering GL columns) were unprofiled at full
width (VERDICT r4 weak #3 / next #2).  This benchmark scores EVERY
individual of a synthetic m x n cohort (default 2M x 180) in both modes
on the chip, with per-phase wall-clock split out:

  prep_tables : the host combo-table pass over all scored individuals
                (includes the D2H GL-column gathers)
  score       : device EMs + z sums + result assembly (everything after)

synth_cohort's GLs are exact functions of the read counts, so the
±0.01 combo-mean site filter keeps essentially all sites — worst-case
(most work) for the device EMs.

Prints one JSON line per mode plus a summary.

Usage:
  python benchmarks/zscore_scale_bench.py [--m 2000000] [--n 180]
      [--inds 180]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=2_000_000)
    ap.add_argument("--n", type=int, default=180)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--inds", type=int, default=None,
                    help="individuals to score (default: all n)")
    args = ap.parse_args()

    import jax
    import numpy as np

    from wgsassign_jax.parallel.mesh import enable_compilation_cache

    enable_compilation_cache()

    from wgsassign_jax.io.beagle import BeagleData
    from wgsassign_jax.io.ids import population_map
    from wgsassign_jax.io.synth import synth_cohort
    from wgsassign_jax.models import zscore as zmod
    from wgsassign_jax.models.common import to_device
    from wgsassign_jax.models.reference_af import estimate_reference_af
    from wgsassign_jax.parallel.mesh import make_runtime

    m = (args.m // 8) * 8
    n = args.n
    inds = args.inds or n
    gl, labels, ad = synth_cohort(m, n, args.k, seed=0)
    beagle = BeagleData(
        gl=gl,
        sample_names=[f"Ind{i}" for i in range(n)],
        site_names=[f"s{i}" for i in range(m)],
    )
    popmap = population_map(np.asarray(beagle.sample_names), labels)
    rt = make_runtime(jax.devices()[:1])
    cohort = to_device(beagle, rt)
    ref = estimate_reference_af(beagle, popmap, cohort=cohort)
    af = np.asarray(ref.af)

    # instrument the host table pass shared by both modes
    orig_prepare = zmod._prepare_tables
    prep_time = [0.0]

    def timed_prepare(*a, **kw):
        t0 = time.perf_counter()
        out = orig_prepare(*a, **kw)
        prep_time[0] += time.perf_counter() - t0
        return out

    zmod._prepare_tables = timed_prepare
    rows = []
    try:
        for mode in ("reference", "assignment"):
            prep_time[0] = 0.0
            t0 = time.perf_counter()
            if mode == "reference":
                res = zmod.reference_z_scores(
                    beagle, ad, popmap, 0, inds, 0, False, cohort=cohort,
                )
            else:
                res = zmod.assignment_z_scores(
                    beagle, ad, labels, af, popmap.pops, 0, inds, 0, False,
                    cohort=cohort,
                )
            np.asarray(res.z)
            total = time.perf_counter() - t0
            rows.append({
                "metric": "zscore_at_scale",
                "mode": mode,
                "m": m, "n": n, "k": args.k, "inds_scored": inds,
                "total_s": round(total, 1),
                "prep_tables_s": round(prep_time[0], 1),
                "score_s": round(total - prep_time[0], 1),
                "per_individual_s": round(total / inds, 2),
                "host_frac": round(prep_time[0] / total, 2),
            })
            print(json.dumps(rows[-1]), flush=True)
    finally:
        zmod._prepare_tables = orig_prepare

    print(json.dumps({
        "metric": "zscore_at_scale_summary",
        "m": m, "n": n, "inds_scored": inds,
        "modes": {r["mode"]: r["total_s"] for r in rows},
        "note": "whole in-process wall-clock on one chip incl. host combo "
                "tables and D2H GL-column gathers; compile excluded only "
                "via the persistent cache (fresh-shape compiles count)",
    }), flush=True)


if __name__ == "__main__":
    main()
