"""BASELINE configs 2 and 5: at-scale assignment LL + the mixture chain.

BASELINE.json names five benchmark configs; rounds 1-4 committed artifacts
for EM, LOO, z-scores, streaming and scaling but never for

  * config 2 — assignment log-likelihoods (``--get_pop_like``) at scale
    (reference path: WGSassign.py:300-308, an N*K serial scan of M sites),
  * config 5 — the ``pop_like`` -> ``--get_em_mix`` / ``--get_mcmc_mix``
    chain (WGSassign.py:450-472) driven from a multi-million-SNP cohort.

Single-process rows
run the real CLI subprocess on the GPU against the cached 5M x 180
headline Beagle.gz (whole wall-clock, parse included, exactly like
file_to_output_bench).  The 2-process row runs the same pop_like CLI
across two ``jax.distributed`` gloo processes on a virtual-CPU mesh (the
same harness as tests/test_multihost.py) over a smaller 2M x 64 cohort —
evidence the sharded path covers config 5's "sharded over N hosts"
clause, not a performance claim for CPU devices.

Prints one JSON line per row plus a summary line.

Usage:
  python benchmarks/assign_mixture_bench.py [--m 5000000] [--n 180]
      [--skip_two_process]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from benchmarks.file_to_output_bench import ensure_data  # noqa: E402

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
from wgsassign_jax.cli import main
main(sys.argv[2:])
"""


def run_cli(flags, env_extra=None, timeout=7200):
    env = dict(os.environ)
    if env_extra:
        env.update(env_extra)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "wgsassign_jax.cli", *map(str, flags)],
        cwd=str(REPO), capture_output=True, text=True, timeout=timeout,
        env=env,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        raise SystemExit(f"CLI failed rc={proc.returncode}")
    return wall


def two_process_pop_like(data_dir, out_prefix, m, n, k):
    """pop_like across 2 gloo processes on a virtual-CPU mesh."""
    beagle, ids = ensure_data(data_dir, m, n, k)
    af_file = data_dir / f"af_m{m}_n{n}_k{k}.npy"
    if not af_file.exists():
        # build an AF panel once (single process, CPU)
        run_cli([
            "--beagle", beagle, "--pop_af_IDs", ids,
            "--get_reference_af", "--out", data_dir / "afgen",
        ], env_extra={"JAX_PLATFORMS": "cpu"})
        os.rename(data_dir / "afgen.pop_af.npy", af_file)
    with tempfile.TemporaryDirectory() as td:
        worker = pathlib.Path(td) / "worker.py"
        worker.write_text(_WORKER)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        flags = [
            "--beagle", str(beagle), "--pop_af_file", str(af_file),
            "--get_pop_like", "--out", str(out_prefix),
        ]
        t0 = time.perf_counter()
        procs = []
        for i in range(2):
            env = dict(
                os.environ,
                WGSA_COORDINATOR_ADDRESS=f"localhost:{port}",
                WGSA_NUM_PROCESSES="2",
                WGSA_PROCESS_ID=str(i),
                JAX_PLATFORMS="cpu",  # virtual-CPU ranks; the card stays free
            )
            procs.append(subprocess.Popen(
                [sys.executable, str(worker), str(REPO), *map(str, flags)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env=env,
            ))
        logs = [p.communicate(timeout=7200)[0] for p in procs]
        wall = time.perf_counter() - t0
        for i, p in enumerate(procs):
            if p.returncode != 0:
                sys.stderr.write(logs[i][-3000:])
                raise SystemExit(f"worker {i} failed")
    return wall


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=5_000_000)
    ap.add_argument("--n", type=int, default=180)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--data_dir", default="/tmp/wgsa_headline")
    ap.add_argument("--m2", type=int, default=2_000_000,
                    help="site count for the 2-process CPU-mesh row")
    ap.add_argument("--n2", type=int, default=64)
    ap.add_argument("--skip_two_process", action="store_true")
    args = ap.parse_args()

    data_dir = pathlib.Path(args.data_dir)
    beagle, ids = ensure_data(data_dir, args.m, args.n, args.k)
    rows = []

    with tempfile.TemporaryDirectory() as td:
        out = pathlib.Path(td) / "am"
        # config 2: reference AF once, then the timed pop_like run (two
        # fresh processes: the second is the warm number)
        run_cli([
            "--beagle", beagle, "--pop_af_IDs", ids,
            "--get_reference_af", "--out", out,
        ])
        pl_walls = [
            run_cli([
                "--beagle", beagle,
                "--pop_af_file", str(out) + ".pop_af.npy",
                "--get_pop_like", "--threads", "0", "--out", out,
            ])
            for _ in range(2)
        ]
        rows.append({
            "config": "pop_like_at_scale",
            "m": args.m, "n": args.n, "k": args.k,
            "device": "gpu", "processes": 1,
            "wall_s_runs": [round(w, 1) for w in pl_walls],
            "warm_wall_s": round(min(pl_walls), 1),
            "note": "whole CLI subprocess: gz parse + H2D + [N,K] LL "
                    "pass + savetxt",
        })

        # config 5: pop_like output -> em_mix and mcmc_mix.  Harvest IDs:
        # 3 groups over the cohort.
        mix_ids = pathlib.Path(td) / "mix.IDs.txt"
        with open(mix_ids, "w") as f:
            for i in range(args.n):
                f.write(f"Ind{i}\tharvest{i % 3}\n")
        em_wall = run_cli([
            "--pop_like", str(out) + ".pop_like.txt",
            "--pop_like_IDs", mix_ids,
            "--pop_names", str(out) + ".pop_names.txt",
            "--get_em_mix", "--out", str(out) + "_em",
        ])
        mcmc_wall = run_cli([
            "--pop_like", str(out) + ".pop_like.txt",
            "--pop_like_IDs", mix_ids,
            "--pop_names", str(out) + ".pop_names.txt",
            "--get_mcmc_mix", "--out", str(out) + "_mcmc",
        ])
        rows.append({
            "config": "mixture_chain_from_5m_cohort",
            "m": args.m, "n": args.n, "k": args.k,
            "device": "host", "processes": 1,
            "em_mix_wall_s": round(em_wall, 1),
            "mcmc_mix_wall_s": round(mcmc_wall, 1),
            "note": "CLI chain on the pop_like matrix computed from the "
                    "5M-site cohort (mixture itself is [N,K] host work, "
                    "as in the reference)",
        })

    if not args.skip_two_process:
        with tempfile.TemporaryDirectory() as td:
            wall2 = two_process_pop_like(
                data_dir, pathlib.Path(td) / "pl2", args.m2, args.n2,
                args.k,
            )
        rows.append({
            "config": "pop_like_2process_sharded",
            "m": args.m2, "n": args.n2, "k": args.k,
            "device": "cpu_virtual_mesh", "processes": 2,
            "wall_s": round(wall2, 1),
            "note": "2 jax.distributed gloo processes x 2 virtual CPU "
                    "devices; sharded-path evidence, not a chip number",
        })

    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({
        "metric": "baseline_configs_2_and_5",
        "rows": len(rows),
        "covered": [r["config"] for r in rows],
    }), flush=True)


if __name__ == "__main__":
    main()
