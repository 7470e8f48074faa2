"""Streamed-vs-in-memory ingest benchmark: peak host RSS + wall-clock.

Generates a synthetic gzipped Beagle file once (reused across runs), then
measures two child processes on the CPU backend (so "device" placement cost
is identical and only host-side behavior differs):

  in-memory : read_beagle (full host matrix) -> to_device
  streamed  : stream_to_device (block parse -> donated device updates)

The streamed path's peak RSS must stay O(block + device arrays) while the
in-memory path pays the full host matrix plus parser copies on top
(VERDICT r01 item 4; the reference holds all of M resident,
reader_cy.pyx:71).

Usage: python benchmarks/stream_ingest_bench.py [--m 1000000] [--n 180]
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, os, resource, sys, time
sys.path.insert(0, __REPO__)
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "")
import jax
jax.config.update("jax_platforms", "cpu")
if os.environ.get("WGSA_COORDINATOR_ADDRESS"):
    jax.distributed.initialize(
        coordinator_address=os.environ["WGSA_COORDINATOR_ADDRESS"],
        num_processes=int(os.environ["WGSA_NUM_PROCESSES"]),
        process_id=int(os.environ["WGSA_PROCESS_ID"]),
    )
from wgsassign_jax.parallel.mesh import make_runtime

mode, path = sys.argv[1], sys.argv[2]
rt = make_runtime()
t0 = time.perf_counter()
if mode == "stream":
    from wgsassign_jax.models.common import stream_to_device
    cohort, meta, _ = stream_to_device(path, rt)
else:
    from wgsassign_jax.io.beagle import read_beagle, read_beagle_sharded
    from wgsassign_jax.models.common import to_device
    src = (read_beagle_sharded(path, rt) if jax.process_count() > 1
           else read_beagle(path))
    cohort = to_device(src, rt)
cohort.g0.block_until_ready()
dt = time.perf_counter() - t0
peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
print(json.dumps({"mode": mode, "seconds": round(dt, 2),
                  "peak_rss_gb": round(peak_gb, 2),
                  "m": int(cohort.m_real), "n": int(cohort.n_inds)}),
      flush=True)
"""


def _run_mode(mode, path, nproc):
    """Run one ingest mode across ``nproc`` jax.distributed processes
    (gloo CPU); returns per-process result dicts (max RSS across them)."""
    if nproc == 1:
        out = subprocess.run(
            [sys.executable, "-c", CHILD.replace("__REPO__", repr(REPO)),
             mode, path],
            capture_output=True, text=True, check=True,
        )
        return [json.loads(out.stdout.strip().splitlines()[-1])]
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for i in range(nproc):
        env = dict(
            os.environ,
            WGSA_COORDINATOR_ADDRESS=f"localhost:{port}",
            WGSA_NUM_PROCESSES=str(nproc),
            WGSA_PROCESS_ID=str(i),
            JAX_PLATFORMS="cpu",  # one process per card is not this bench
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD.replace("__REPO__", repr(REPO)),
             mode, path],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        ))
    results = []
    for i, p in enumerate(procs):
        out, err = p.communicate(timeout=1800)
        if p.returncode != 0:
            raise RuntimeError(f"proc {i} failed:\n{err[-3000:]}")
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=1_000_000)
    ap.add_argument("--n", type=int, default=180)
    ap.add_argument("--file", default=None)
    ap.add_argument("--nproc", type=int, default=1,
                    help="jax.distributed processes (multi-host streamed "
                         "ingest: per-process RSS must stay O(block))")
    args = ap.parse_args()

    path = args.file or f"/tmp/wgsa_synth_{args.m}x{args.n}.beagle.gz"
    if not os.path.exists(path):
        sys.path.insert(0, REPO)
        from wgsassign_jax.io.synth import synth_beagle_file

        print(f"generating {path} ({args.m} x {args.n})...", file=sys.stderr)
        t0 = time.time()
        synth_beagle_file(path, args.m, args.n)
        print(f"generated in {time.time() - t0:.0f}s "
              f"({os.path.getsize(path) / 1e9:.2f} GB)", file=sys.stderr)

    results = {}
    for mode in ("stream", "inmemory"):
        per_proc = _run_mode(mode, path, args.nproc)
        for r in per_proc:
            print(json.dumps(r), file=sys.stderr)
        results[mode] = dict(
            per_proc[0],
            peak_rss_gb=max(r["peak_rss_gb"] for r in per_proc),
            seconds=max(r["seconds"] for r in per_proc),
        )

    gl_gb = args.m * args.n * 2 * 4 / 1e9
    print(json.dumps({
        "workload": "stream_ingest",
        "m": args.m, "n": args.n, "nproc": args.nproc,
        "gl_matrix_gb": round(gl_gb, 2),
        "file_gb": round(os.path.getsize(path) / 1e9, 2),
        "stream_peak_rss_gb": results["stream"]["peak_rss_gb"],
        "inmemory_peak_rss_gb": results["inmemory"]["peak_rss_gb"],
        "stream_seconds": results["stream"]["seconds"],
        "inmemory_seconds": results["inmemory"]["seconds"],
        "host_overhead_stream_gb": round(
            results["stream"]["peak_rss_gb"] - gl_gb, 2),
        "host_overhead_inmemory_gb": round(
            results["inmemory"]["peak_rss_gb"] - gl_gb, 2),
    }))


if __name__ == "__main__":
    main()
