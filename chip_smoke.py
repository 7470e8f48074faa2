"""Smoke run of the WGSassign engine on one NVIDIA GPU.

    python chip_smoke.py                # phases A and B on one card
    python chip_smoke.py --four-cards   # phase B on a 4-card mesh vs 1 card

Phase A is the upstream README's documented run at 600k sites x 80
individuals, K=5 (16 each, an assumed split): a Beagle.gz generated from
``--seed`` goes through the CLI (``--get_reference_af --ne_obs --loo``,
then ``--get_pop_like`` and ``--get_em_mix`` on its outputs), and the
outputs are checked against ``tests/oracle.py``.  Phase B is the headline
shape, 5M sites x 180 individuals, K=5 (36 each): a cohort generated on the
device runs reference AF, Ne and LOO through ``models/``, checked against
the oracle at sampled sites and against the simulated populations.

Everything runs in this one process.  The last line of standard output is
one JSON object with ``ok`` and the device; any failure raises and exits
non-zero before it is printed.  Without a GPU the run stops at once.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

A_SITES, A_INDS = 600_000, 80
B_SITES, B_POP = 5_000_000, 36
K = 5
AF_TOL = 1e-4      # the EM's own convergence tolerance
REL_TOL = 1e-5     # Ne, Fisher information and log-likelihoods
LOO_SUBSET = 8     # individuals whose LOO the host oracle recomputes
SAMPLE_SITES = 2048


def log(msg):
    print(msg, flush=True)


def check(name, ok, detail):
    log(f"  check {name}: {'pass' if ok else 'FAIL'} ({detail})")
    if not ok:
        raise AssertionError(f"{name}: {detail}")


def rel_err(a, b):
    """Largest elementwise relative error, with the denominator floored at
    1e-3 of the reference's largest magnitude (near-zero entries)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    floor = 1e-3 * np.max(np.abs(b))
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), floor)))


def peak_gib(dev):
    return dev.memory_stats()["peak_bytes_in_use"] / 2**30


# ---------------------------------------------------------------------------
# phase A: the CLI on a generated Beagle.gz, checked against the oracle
# ---------------------------------------------------------------------------

def oracle_loo_subset(L, af_full, labels, subset, max_iter=200, tol=1e-4):
    """The oracle LOO (reference in-place AF order) for ``subset`` only:
    individual i sees, for population j, the LOO AF of the last j-member
    with index <= i, or the full-data AF when there is none."""
    import numpy as np
    import oracle

    pops = np.unique(labels)
    g0, g1 = oracle.split_gl(L)
    loo_af = {}

    def loo_of(i):
        if i not in loo_af:
            idx, cols = oracle.pop_columns(labels, labels[i], exclude=i)
            f, _ = oracle.emmaf(L[:, cols], max_iter, tol)
            loo_af[i] = oracle.clamp_af(f, len(idx))
        return loo_af[i]

    ll = np.zeros((len(subset), len(pops)))
    for r, i in enumerate(subset):
        for j, pop in enumerate(pops):
            members = np.flatnonzero(labels == pop)
            prior = members[members <= i]
            a = loo_of(int(prior.max())) if prior.size else af_full[:, j]
            ll[r, j] = np.sum(oracle.site_loglik(g0[:, i], g1[:, i], a),
                              dtype=np.float64)
    return ll


def ne_ind_f64(L, af, labels):
    """The oracle's individual Ne with its site mean taken in float64: a
    float32 running sum over 600k sites drifts by about 1e-4 relative,
    which would hide the engine's own error."""
    import numpy as np
    import oracle

    g0, g1 = oracle.split_gl(np.asarray(L, np.float32))
    th = np.asarray(af, np.float32)[:, np.searchsorted(np.unique(labels),
                                                        labels)]
    term = 0.5 * oracle.fisher_term(g0, g1, th) * th * (1.0 - th)
    return term.astype(np.float32).mean(axis=0, dtype=np.float64)


def phase_a(seed, dev):
    import numpy as np
    import pandas as pd

    import oracle
    from wgsassign_jax import _native
    from wgsassign_jax.cli import main as cli
    from wgsassign_jax.io.beagle import read_beagle, to_legacy_matrix
    from wgsassign_jax.io.synth import synth_beagle_file

    log(f"phase A: CLI at {A_SITES} sites x {A_INDS} individuals, K={K} "
        f"(assumed split: {A_INDS // K} per population)")
    native_reads = []
    read_native = _native.read_beagle_native

    def counting_read(*a, **kw):
        out = read_native(*a, **kw)
        native_reads.append(out is not None)
        return out

    _native.read_beagle_native = counting_read
    with tempfile.TemporaryDirectory() as td:
        t = time.perf_counter()
        beagle = os.path.join(td, "cohort.beagle.gz")
        synth_beagle_file(beagle, A_SITES, A_INDS, n_pops=K, seed=seed)
        labels = np.array([f"pop{i % K}" for i in range(A_INDS)])
        ids = os.path.join(td, "ids.txt")
        with open(ids, "w") as f:
            f.writelines(f"Ind{i}\t{lab}\n" for i, lab in enumerate(labels))
        log(f"  generated {os.path.getsize(beagle) / 2**20:.1f} MiB "
            f"Beagle.gz in {time.perf_counter() - t:.1f} s")

        out = os.path.join(td, "run")
        t = time.perf_counter()
        cli(["--beagle", beagle, "--pop_af_IDs", ids, "--get_reference_af",
             "--ne_obs", "--loo", "-o", out])
        t_main = time.perf_counter() - t
        t = time.perf_counter()
        cli(["--beagle", beagle, "--pop_af_file", out + ".pop_af.npy",
             "--get_pop_like", "-o", out + "_assign"])
        cli(["--pop_like", out + "_assign.pop_like.txt", "--pop_like_IDs",
             ids, "--get_em_mix", "--stable_mix", "-o", out + "_mix"])
        t_assign = time.perf_counter() - t
        log(f"phase A CLI times: reference AF + Ne + LOO {t_main:.2f} s, "
            f"pop_like + em_mix {t_assign:.2f} s (compiles included); "
            f"peak device memory {peak_gib(dev):.2f} GiB")
        check("native Beagle parser used", bool(native_reads)
              and all(native_reads), f"{len(native_reads)} native reads")

        t = time.perf_counter()
        L = to_legacy_matrix(read_beagle(beagle))
        af = np.load(out + ".pop_af.npy")
        af_ref, _ = oracle.reference_af(L, labels)
        check("reference AF vs oracle", np.abs(af - af_ref).max() <= AF_TOL,
              f"max abs diff {np.abs(af - af_ref).max():.3g} <= {AF_TOL}")
        f_obs, ne_obs, _ = oracle.fisher_ne(L, af, labels)
        for name, got, ref in (
            ("Fisher information", np.load(out + ".fisher_obs.npy"), f_obs),
            ("per-site Ne", np.load(out + ".ne_obs.npy"), ne_obs),
            ("individual Ne", np.loadtxt(out + ".ne_ind.txt"),
             ne_ind_f64(L, af, labels)),
        ):
            e = rel_err(got, ref)
            check(f"{name} vs oracle", e <= REL_TOL,
                  f"max rel err {e:.3g} <= {REL_TOL}")
        ll = np.loadtxt(out + "_assign.pop_like.txt")
        ll_ref = oracle.assign_ll(L, af)
        e = rel_err(ll, ll_ref)
        check("assignment log-likelihoods vs oracle", e <= REL_TOL,
              f"max rel err {e:.3g} <= {REL_TOL}")

        loo = pd.read_csv(out + ".pop_like_LOO.tsv", sep="\t")
        loo = loo.iloc[:, 2:].to_numpy(np.float64)
        subset = list(range(LOO_SUBSET))
        loo_ref = oracle_loo_subset(L, af, labels, subset)
        top2 = np.sort(loo_ref, axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-3 * np.abs(top2[:, 1])
        same = loo[subset].argmax(1) == loo_ref.argmax(1)
        check(f"LOO argmax vs oracle (individuals 0-{LOO_SUBSET - 1})",
              bool(np.all(same | ~clear)),
              f"{int(same.sum())}/{LOO_SUBSET} agree, "
              f"{int(clear.sum())} with a top-two gap > 1e-3 |LL|; "
              f"max rel LL err {rel_err(loo[subset], loo_ref):.3g}")

        mix = np.loadtxt(out + "_mix.em_mix.txt", dtype=str)
        _, pi_ref = oracle.em_mix(ll - ll.max(axis=1, keepdims=True), labels)
        d = np.abs(mix[:, 1:].astype(np.float64) - pi_ref).max()
        check("EM mixture proportions vs oracle", d <= 1e-6,
              f"max abs diff {d:.3g} <= 1e-6")
        log(f"  oracle checks took {time.perf_counter() - t:.1f} s")
    _native.read_beagle_native = read_native


# ---------------------------------------------------------------------------
# phase B: 5M x 180 through models/, cohort generated on the device
# ---------------------------------------------------------------------------

def make_headline(seed):
    import numpy as np

    from wgsassign_jax.io.ids import population_map
    from wgsassign_jax.io.synth import synth_device_panels

    g0, g1, pop_of = synth_device_panels(B_SITES, [B_POP] * K, seed=seed)
    popmap = population_map([f"Ind{i}" for i in range(K * B_POP)],
                            [f"pop{p}" for p in pop_of])
    return g0, g1, np.asarray(pop_of), popmap


def run_models(cohort, popmap):
    """Reference AF -> Ne -> LOO on a device cohort; returns the results
    and the wall time, each output fetched to the host."""
    from wgsassign_jax.models.loo import leave_one_out
    from wgsassign_jax.models.ne import effective_sample_sizes
    from wgsassign_jax.models.reference_af import estimate_reference_af

    t = time.perf_counter()
    ref = estimate_reference_af(None, popmap, cohort=cohort)
    ne = effective_sample_sizes(None, ref.af, popmap, cohort=cohort)
    loo = leave_one_out(None, ref.af, popmap, cohort=cohort)
    return ref, ne, loo, time.perf_counter() - t


def phase_b(seed, dev):
    import numpy as np

    import oracle
    from wgsassign_jax.models.common import place_panels
    from wgsassign_jax.parallel.mesh import make_runtime

    log(f"phase B: models/ at {B_SITES} sites x {K * B_POP} individuals, "
        f"K={K} ({B_POP} per population), generated on the device")
    rt = make_runtime([dev])
    log(f"  engine path: {rt.engine}")
    t = time.perf_counter()
    g0, g1, pop_of, popmap = make_headline(seed)
    cohort = place_panels(g0, g1, rt)
    cohort.g0.block_until_ready()
    log(f"  generated and placed in {time.perf_counter() - t:.1f} s")
    _, _, _, t_first = run_models(cohort, popmap)
    ref, ne, loo, t_steady = run_models(cohort, popmap)
    log(f"phase B times: reference AF + Ne + LOO {t_first:.2f} s with "
        f"compiles, {t_steady:.2f} s steady; EM iterations "
        f"{ref.iters.tolist()}; peak device memory {peak_gib(dev):.2f} GiB")

    check("reference AF converged and in (0, 1)",
          bool(ref.converged.all() and np.all((ref.af > 0) & (ref.af < 1))),
          f"iterations {ref.iters.tolist()}")
    # oracle at sampled sites: the same number of EM updates per population
    rng = np.random.default_rng(seed)
    sites = np.sort(rng.choice(B_SITES, SAMPLE_SITES, replace=False))
    L = np.empty((SAMPLE_SITES, 2 * K * B_POP), np.float32)
    L[:, 0::2] = np.asarray(g0[sites])
    L[:, 1::2] = np.asarray(g1[sites])
    labels = popmap.pop_labels
    err = 0.0
    for k, pop in enumerate(popmap.pops):
        idx, cols = oracle.pop_columns(labels, pop)
        f, _ = oracle.emmaf(L[:, cols], int(ref.iters[k]), -1.0)
        err = max(err, np.abs(oracle.clamp_af(f, len(idx))
                              - ref.af[sites, k]).max())
    check("reference AF vs oracle at sampled sites", err <= AF_TOL,
          f"max abs diff {err:.3g} <= {AF_TOL} over {SAMPLE_SITES} sites")
    f_obs, ne_obs, _ = oracle.fisher_ne(L, ref.af[sites], labels)
    e = max(rel_err(ne.f_obs[sites], f_obs), rel_err(ne.ne_obs[sites], ne_obs))
    check("Fisher information and Ne vs oracle at sampled sites",
          e <= REL_TOL, f"max rel err {e:.3g} <= {REL_TOL}")
    check("individual Ne finite and positive",
          bool(np.all(np.isfinite(ne.ne_ind) & (ne.ne_ind > 0))),
          f"range {ne.ne_ind.min():.4g}..{ne.ne_ind.max():.4g}")
    right = float(np.mean(loo.ll.argmax(1) == pop_of))
    check("LOO assigns every individual to its simulated population",
          bool(np.isfinite(loo.ll).all()) and right == 1.0,
          f"shape {loo.ll.shape}, {right:.3f} assigned to own population")


def phase_b_four_cards(seed):
    import jax
    import numpy as np

    from wgsassign_jax.models.common import place_panels
    from wgsassign_jax.parallel.mesh import make_runtime

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devs)}")
    log(f"phase B on 4 cards vs 1: {B_SITES} sites x {K * B_POP} individuals")
    g0, g1, pop_of, popmap = make_headline(seed)
    out = {}
    for n in (1, 4):
        rt = make_runtime(devs[:n])
        log(f"  engine path: {rt.engine}")
        cohort = place_panels(g0, g1, rt)
        run_models(cohort, popmap)
        out[n] = run_models(cohort, popmap)
        log(f"  {n} card(s): reference AF + Ne + LOO {out[n][3]:.3f} s "
            f"steady, EM iterations {out[n][0].iters.tolist()}")
        del cohort
    (r1, n1, l1, t1), (r4, n4, l4, t4) = out[1], out[4]
    log(f"  4-card speedup {t1 / t4:.2f}x, scaling efficiency "
        f"{t1 / t4 / 4:.3f}")
    check("4-card EM iterations equal 1-card",
          bool(np.array_equal(r1.iters, r4.iters)),
          f"{r1.iters.tolist()} vs {r4.iters.tolist()}")
    d = np.abs(r1.af - r4.af).max()
    check("4-card reference AF vs 1-card", d <= 1e-6, f"max abs diff {d:.3g}")
    e = max(rel_err(n4.ne_ind, n1.ne_ind), rel_err(l4.ll, l1.ll))
    check("4-card Ne and LOO vs 1-card", e <= REL_TOL,
          f"max rel err {e:.3g} <= {REL_TOL}")
    check("4-card LOO argmax equals 1-card",
          bool(np.array_equal(l1.ll.argmax(1), l4.ll.argmax(1))),
          f"{float(np.mean(l4.ll.argmax(1) == pop_of)):.3f} assigned "
          "to own population")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase B on a 4-card mesh against 1 card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU found (platform {devs[0].platform})")
    from wgsassign_jax.parallel.mesh import enable_compilation_cache

    enable_compilation_cache()
    jax.config.update("jax_default_matmul_precision", "highest")
    log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    t = time.perf_counter()
    if args.four_cards:
        phase_b_four_cards(args.seed)
    else:
        phase_a(args.seed, devs[0])
        phase_b(args.seed, devs[0])
    log(f"all phases passed in {time.perf_counter() - t:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
