"""MAF-EM throughput on one NVIDIA GPU: site-individual GL updates/s of the
engine's reference-AF EM (``ops/emmaf.em_maf_pops``, plain XLA).

Prints the card's name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

The per-iteration time is the slope between a short and a long fixed-count
EM run (dispatch and transfer cancel), measured ``REPS`` times; the JSON
carries the median and every repetition.  Roofline shares divide by the
card's published peaks (``PEAKS``); a card missing from the table is an
error.  ``vs_baseline`` compares against a measured CPU run of the
reference EM inner loop (emMAF_cy.pyx:10-23), extrapolated to the 64
threads of BASELINE.md from the measured per-core throughput and thread
scaling.

    python bench.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

M = 1 << 22
N = 128
K = 4
SHORT, LONG = 10, 50   # EM iterations of the two timing points
REPS = 7
CAL_M = 1 << 15  # CPU calibration runs a smaller site count

# FLOPs per site-individual EM update (em_weights: 1 sub, 3 muls for p0,
# 4 for p1, 3 for p2, 2 adds + 1 mul + 1 add for the fraction, 1 div, and
# the accumulate); bytes per update: the two float32 GL panels read once
# per iteration.
FLOPS_PER_UPDATE = 16
BYTES_PER_UPDATE = 8

# Published peaks by device kind: NVIDIA H100 data sheet, SXM part, dense;
# float32 outside the tensor cores.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def _synthetic_gl(m, n, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)
    return raw[:, :, 0], raw[:, :, 1]


def _cpu_update_slice(g0, g1, g2, f):
    omf = 1.0 - f
    p0 = g0 * omf * omf
    p1 = g1 * 2.0 * f * omf
    p2 = g2 * f * f
    w = (p1 + 2.0 * p2) / (2.0 * (p0 + p1 + p2))
    return w.mean(axis=1, keepdims=True, dtype=np.float32)


def cpu_reference_measured():
    """Measured CPU throughput of the reference EM update.

    Returns ``(updates_per_sec_1t, updates_per_sec_all, threads,
    efficiency)`` where efficiency = measured all-thread speedup / threads.
    """
    from concurrent.futures import ThreadPoolExecutor

    threads = max(os.cpu_count() or 1, 1)
    g0, g1 = _synthetic_gl(CAL_M, N, seed=1)
    g2 = 1.0 - g0 - g1
    f = np.full((CAL_M, 1), 0.25, dtype=np.float32)

    def timed(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return CAL_M * N / float(np.median(times))

    # all-thread: split the site axis; NumPy ufuncs release the GIL, so
    # threads scale like the reference's OpenMP prange until memory-bound
    bounds = np.linspace(0, CAL_M, threads + 1).astype(int)
    slices = [slice(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]
    with ThreadPoolExecutor(threads) as pool:
        tp_all = timed(lambda: list(pool.map(
            lambda s: _cpu_update_slice(g0[s], g1[s], g2[s], f[s]), slices
        )))
    tp1 = timed(lambda: _cpu_update_slice(g0, g1, g2, f))
    efficiency = min(tp_all / (tp1 * threads), 1.0)
    return tp1, tp_all, threads, efficiency


def device_updates_per_sec():
    import jax

    from wgsassign_jax.io.synth import synth_device_panels
    from wgsassign_jax.models.common import place_panels
    from wgsassign_jax.ops.emmaf import em_maf_pops
    from wgsassign_jax.parallel.mesh import (
        enable_compilation_cache,
        make_runtime,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU found (platform {dev.platform})")
    if dev.device_kind not in PEAKS:
        raise KeyError(f"no published peaks for {dev.device_kind!r}")
    peaks = PEAKS[dev.device_kind]
    enable_compilation_cache()
    rt = make_runtime([dev])
    g0, g1, pop_of = synth_device_panels(M, [N // K] * K, seed=0)
    cohort = place_panels(g0, g1, rt)
    membership = np.zeros((N, K), np.float32)
    membership[np.arange(N), pop_of] = 1.0
    mem_d = rt.replicate(membership)
    idx_d = rt.replicate(pop_of)

    def run(iters):
        t0 = time.perf_counter()
        f, _, _ = em_maf_pops(cohort.g0, cohort.g1, mem_d, idx_d,
                              cohort.site_weight, M, iters, 0.0)
        f.block_until_ready()
        return time.perf_counter() - t0

    run(SHORT), run(LONG)  # compile both iteration counts
    slopes = []
    for _ in range(REPS):
        t_short, t_long = run(SHORT), run(LONG)
        slopes.append(max((t_long - t_short) / (LONG - SHORT), 1e-9))
    per_iter = float(np.median(slopes))
    updates = M * N / per_iter
    return {
        "value": updates,
        "per_iter_s": per_iter,
        "per_rep_updates_per_sec": [M * N / s for s in slopes],
        "value_rel_spread": (max(slopes) - min(slopes)) / per_iter,
        "device_kind": dev.device_kind,
        "f32_peak_share": FLOPS_PER_UPDATE * updates / peaks["f32_flops"],
        "hbm_peak_share": BYTES_PER_UPDATE * updates / peaks["hbm_bytes"],
        "engine": rt.engine,
    }


def main():
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    dev = device_updates_per_sec()
    tp1, tp_all, threads, eff = cpu_reference_measured()
    baseline_64t = tp1 * 64.0 * eff
    print(json.dumps({
        "metric": "maf_em_gl_updates_per_sec_per_chip",
        "value": dev["value"],
        "unit": "site-individual EM updates/s",
        # against the extrapolated 64-thread CPU figure, an upper bound on
        # the reference CPU; vs_baseline_measured_allt is the ratio against
        # the only number this host measures directly
        "vs_baseline": dev["value"] / baseline_64t,
        "vs_baseline_measured_allt": dev["value"] / tp_all,
        **{k: v for k, v in dev.items() if k != "value"},
        "baseline": {
            "cpu_updates_per_sec_1t_measured": tp1,
            "cpu_updates_per_sec_allt_measured": tp_all,
            "cpu_threads_measured": threads,
            "cpu_scaling_efficiency_measured": eff,
            "cpu_updates_per_sec_64t_extrapolated": baseline_64t,
        },
    }))


if __name__ == "__main__":
    main()
