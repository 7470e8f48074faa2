"""Scaling benchmark harness: SNPs/s at 1 chip / N virtual devices, for the
MAF EM, the batched LOO, and the assignment log-likelihood pass.

Usage:
  python benchmarks/scaling_bench.py [--m 1000000] [--n 180] [--k 5]
                                     [--devices 1] [--cpu]

Prints one JSON line per workload.  On the CPU platform pass --cpu (sets the
virtual-device flag before importing jax).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=1_000_000)
    ap.add_argument("--n", type=int, default=180)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from wgsassign_jax.io.synth import synth_cohort
    from wgsassign_jax.ops.emmaf import em_maf_loo_group, em_maf_pops
    from wgsassign_jax.ops.loglik import assign_loglik
    from wgsassign_jax.parallel.mesh import make_runtime

    rt = make_runtime(jax.devices()[: args.devices])
    m = (args.m // (8 * rt.n_devices)) * (8 * rt.n_devices)
    gl, labels, _ = synth_cohort(m, args.n, args.k, seed=0)
    pop_index = np.array([int(s[3:]) for s in labels], dtype=np.int32)
    membership = np.zeros((args.n, args.k), np.float32)
    membership[np.arange(args.n), pop_index] = 1.0

    g0 = rt.shard_sites(np.ascontiguousarray(gl[:, :, 0]))
    g1 = rt.shard_sites(np.ascontiguousarray(gl[:, :, 1]))
    sw = rt.shard_sites(np.ones(m, np.float32))
    mem = rt.replicate(membership)
    pidx = rt.replicate(pop_index)

    def bench(name, fn, updates, reps=3):
        fn(0)  # compile
        best = float("inf")
        for r in range(1, reps + 1):
            t0 = time.perf_counter()
            fn(r)
            best = min(best, time.perf_counter() - t0)
        print(json.dumps({
            "workload": name, "m": m, "n": args.n, "k": args.k,
            "devices": rt.n_devices, "seconds": round(best, 4),
            "updates_per_sec": round(updates / best, 1),
        }), flush=True)

    it = args.iters

    def em(r):
        out = em_maf_pops(g0, g1, mem, pidx, sw, m, it, -1e-30 * (r + 1))
        np.asarray(out[1])

    bench("maf_em_xla", em, m * args.n * it)

    # LOO for the largest population (site-minor member panels)
    from jax.sharding import NamedSharding, PartitionSpec as P

    from wgsassign_jax.parallel.mesh import SNP_AXIS

    members = np.flatnonzero(pop_index == 0)
    row_sharding = NamedSharding(rt.mesh, P(None, SNP_AXIS))
    g0p = jax.device_put(np.ascontiguousarray(gl[:, members, 0].T), row_sharding)
    g1p = jax.device_put(np.ascontiguousarray(gl[:, members, 1].T), row_sharding)

    def loo(r):
        out = em_maf_loo_group(g0p, g1p, sw, m, it, -1e-30 * (r + 1))
        np.asarray(out[1])

    npop = len(members)
    bench("loo_em_one_pop", loo, m * npop * npop * it)

    af = jnp.full((m, args.k), 0.3, jnp.float32)

    def ll(r):
        out = assign_loglik(g0 + 1e-9 * r, g1, af, sw)
        np.asarray(out[:1, :1])

    bench("assign_loglik", ll, m * args.n * args.k)


if __name__ == "__main__":
    main()
