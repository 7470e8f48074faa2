"""Headline benchmark: end-to-end leave-one-out cross-validation wall-clock.

The reference's only published performance claim (README.md:129-131) is the
LOO workload: "~30 minutes for ~5 million SNPs x 180 individuals" (and
"<1 minute for 600k SNPs x 80 individuals") on an unspecified HPC node.
This benchmark runs the SAME end-to-end pipeline — reference-AF EM for all
populations + N batched LOO EM re-runs + the N*K assignment log-likelihood
pass, with real convergence semantics (tol 1e-4, max 200 iters) — on one
GPU and reports wall-clock plus the speedup vs the reference claim.

Timing excludes synthetic-data generation and host Beagle parsing (the
reference claim is also compute-dominated; our parser is benchmarked
separately in tests/test_io.py and the scaling bench).

Usage:
  python benchmarks/loo_headline_bench.py [--m 5000000] [--n 180] [--k 5]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# Reference claim: 5M x 180 LOO in ~30 min (README.md:129-131).
REF_SECONDS = 30 * 60.0
REF_M = 5_000_000
REF_N = 180


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=5_000_000)
    ap.add_argument("--n", type=int, default=180)
    ap.add_argument("--k", type=int, default=5)
    args = ap.parse_args()

    import jax
    import numpy as np

    from wgsassign_jax.parallel.mesh import enable_compilation_cache

    enable_compilation_cache()

    from wgsassign_jax.io.beagle import BeagleData
    from wgsassign_jax.io.ids import population_map
    from wgsassign_jax.io.synth import synth_cohort
    from wgsassign_jax.models.common import to_device
    from wgsassign_jax.models.loo import leave_one_out
    from wgsassign_jax.models.reference_af import estimate_reference_af
    from wgsassign_jax.parallel.mesh import make_runtime

    m = (args.m // 8) * 8
    gl, labels, _ = synth_cohort(m, args.n, args.k, seed=0)
    beagle = BeagleData(
        gl=gl,
        sample_names=[f"Ind{i}" for i in range(args.n)],
        site_names=[f"s{i}" for i in range(m)],
    )
    popmap = population_map(np.asarray(beagle.sample_names), labels)

    rt = make_runtime(jax.devices()[:1])
    cohort = to_device(beagle, rt)

    def run():
        t0 = time.perf_counter()
        ref = estimate_reference_af(beagle, popmap, cohort=cohort)
        res = leave_one_out(beagle, ref.af, popmap, cohort=cohort)
        np.asarray(res.ll)
        return time.perf_counter() - t0, res

    # The first call compiles; report both.
    cold_seconds, _ = run()
    seconds, res = run()

    # Scale the reference claim to the benchmarked shape: LOO cost is
    # ~ M * N * n_pop per EM sweep, i.e. linear in M and ~quadratic in N at
    # fixed K.  Scale conservatively by work = m * n^2.
    ref_scaled = REF_SECONDS * (m * args.n**2) / (REF_M * REF_N**2)
    print(json.dumps({
        "workload": "loo_end_to_end",
        "engine": rt.engine,
        "m": m, "n": args.n, "k": args.k,
        "seconds": round(seconds, 2),
        "cold_seconds_incl_compile": round(cold_seconds, 2),
        "reference_seconds_scaled": round(ref_scaled, 1),
        "speedup_vs_reference": round(ref_scaled / seconds, 1),
        "loo_em_iters_min": int(res.iters.min()),
        "loo_em_iters_max": int(res.iters.max()),
    }), flush=True)


if __name__ == "__main__":
    main()
