"""Flag-compatible command-line driver.

Mirrors the reference CLI contract (WGSassign.py:24-104 flag set, analysis
dispatch at :109-472, output files and formats) on top of the JAX engine.
Blocks compose in one run exactly like the reference (e.g.
``--get_reference_af --ne_obs --loo``).

Engine additions (all optional): ``--devices`` to cap the mesh size,
``--profile`` to dump a jax profiler trace, ``--stable_mix`` for the
log-sum-exp mixture EM, ``--loo_clean_af`` to disable the reference's
in-place LOO AF quirk, ``--mcmc_seed``/``--mcmc_last_draw`` for the (fixed)
MCMC mixture.

Behavioral deviations from the reference, all documented:
  * ``--ind_start 0`` is accepted (the reference's assert rejected 0 despite
    its help text claiming 0-indexing, WGSassign.py:335);
  * ``--get_mcmc_mix`` works (the reference crashed, mixture.py:75) and
    writes ``.mcmc_mix.txt`` (the reference would have clobbered
    ``.em_mix.txt``, WGSassign.py:470);
  * ``--threads`` is accepted for compatibility and controls host-side
    parser threads only — device parallelism comes from the mesh.  Its
    default is 0 (all cores) rather than the reference's 1, because here it
    only governs ingest bandwidth, not compute.
"""

from __future__ import annotations

import argparse
import os
import sys

from wgsassign_jax.version import __version__

parser = argparse.ArgumentParser(prog="WGSassign")
parser.add_argument("-b", "--beagle", metavar="FILE",
    help="Filepath to genotype likelihoods in gzipped Beagle format from ANGSD")
parser.add_argument("-t", "--threads", metavar="INT", type=int, default=0,
    help="Number of host threads for the Beagle parser (default 0 = all "
         "cores); device parallelism uses the mesh")
parser.add_argument("-o", "--out", metavar="OUTPUT", default="wgsassign",
    help="Prefix for output files")
parser.add_argument("--maf_iter", metavar="INT", type=int, default=200,
    help="Maximum iterations for minor allele frequencies estimation - EM (200)")
parser.add_argument("--maf_tole", metavar="FLOAT", type=float, default=1e-4,
    help="Tolerance for minor allele frequencies estimation update - EM (1e-4)")

# Reference population allele frequencies
parser.add_argument("--pop_af_IDs", metavar="FILE",
    help="Filepath to individual IDs and populations for beagle")
parser.add_argument("--get_reference_af", action="store_true",
    help="Estimate allele frequencies for reference populations")
parser.add_argument("--pop_names", metavar="FILE",
    help="Filepath to population names of allele frequency file")

# Effective sample size / Fisher info
parser.add_argument("--ne_obs", action="store_true",
    help="Estimate population and individuals effective sample sizes")

# Leave-one-out
parser.add_argument("--loo", action="store_true",
    help="Perform leave-one-out cross validation")
parser.add_argument("--loo_downsampled_beagle", metavar="FILE",
    help="Optional Beagle file of downsampled genotype likelihoods to use for "
         "LOO assignment")

# Assignment likelihoods
parser.add_argument("--pop_af_file", metavar="FILE",
    help="Filepath to reference population allele frequencies")
parser.add_argument("--get_pop_like", action="store_true",
    help="Estimate log likelihood of individual assignment to each reference population")
parser.add_argument("--partition_sites", type=int, metavar="INT", default=1,
    help="Optional: partition sites into INT subsets (by modulo) and report "
         "assignment log-likelihoods for each subset")

# Z-score
parser.add_argument("--get_assignment_z_score", action="store_true",
    help="Calculate z-score for individuals (assigned-population AF mode)")
parser.add_argument("--get_reference_z_score", action="store_true",
    help="Calculate z-score for individuals (own-population LOO AF mode)")
parser.add_argument("--ind_ad_file", metavar="FILE",
    help="Filepath to individual allele depths, tab-delimited, .txt or .gz")
parser.add_argument("--allele_count_threshold", metavar="INT", type=int,
    help="Minimum number of loci needed to keep a specific allele count combination")
parser.add_argument("--single_read_threshold", action="store_true",
    help="Use only loci with a single read")
parser.add_argument("--ind_start", metavar="INT", type=int,
    help="Start analysis at this individual index (0-indexed)")
parser.add_argument("--ind_end", metavar="INT", type=int,
    help="End analysis at this individual index (exclusive upper bound)")
parser.add_argument("--zscore_error_rate", metavar="FLOAT", type=float,
    default=0.01,
    help="Sequencing error rate for the z-score read-probability tables "
         "(the reference hard-codes 0.01, WGSassign.py:350,430)")

# Mixture proportions
parser.add_argument("--pop_like", metavar="FILE",
    help="Filepath to population assignment log likelihood file")
parser.add_argument("--pop_like_IDs", metavar="FILE",
    help="Filepath to IDs for population assignment log likelihood file")
parser.add_argument("--get_em_mix", action="store_true",
    help="Estimate mixture proportions with EM algorithm")
parser.add_argument("--get_mcmc_mix", action="store_true",
    help="Estimate mixture proportions with MCMC algorithm")
parser.add_argument("--mixture_iter", metavar="INT", type=int, default=200,
    help="Maximum iterations mixture estimation - EM (200)")

# Engine options (not in the reference)
parser.add_argument("--devices", metavar="INT", type=int, default=None,
    help="Use only the first INT devices of the mesh (default: all)")
parser.add_argument("--profile", metavar="DIR",
    help="Write a jax profiler trace of the run to DIR")
parser.add_argument("--stable_mix", action="store_true",
    help="Log-sum-exp mixture EM (immune to exp underflow)")
parser.add_argument("--loo_clean_af", action="store_true",
    help="LOO: evaluate foreign populations with full-data AF instead of "
         "reproducing the reference's in-place mutation order dependence")
parser.add_argument("--mcmc_seed", metavar="INT", type=int, default=None,
    help="Random seed for --get_mcmc_mix")
parser.add_argument("--mcmc_last_draw", action="store_true",
    help="MCMC: report the last draw instead of the posterior mean")
parser.add_argument("--f32_sums", action="store_true",
    help="Accumulate site-axis log-likelihood sums in float32 (single fused "
         "reduction) instead of the reference-matching blocked-f64 scheme")
parser.add_argument("--stream_ingest", metavar="ROWS", type=int, default=None,
    help="Stream the Beagle file to device in site blocks of ROWS rows "
         "(0 = auto-size ~256 MiB blocks) instead of materializing the full "
         "GL matrix on host — M is then bounded by device memory, not host RAM. "
         "Works with every analysis: z-scores gather per-individual GL "
         "columns back from the device cohort, and the downsampled-LOO "
         "site intersection streams through a site-name scan pass. "
         "Composes with multi-host runs: each process streams only its own "
         "row window into its local devices")
parser.add_argument("--em_checkpoint", action="store_true",
    help="Checkpoint the LOO EM per population next to the output prefix "
         "and resume from it (requires --loo; the reference-AF EM is one "
         "device loop and is not checkpointed)")
parser.add_argument("--debug_checks", action="store_true",
    help="Enable NaN debugging (jax_debug_nans) plus checkify sanitizers "
         "on the likelihood paths (catches malformed GL triples that would "
         "silently produce -inf log-likelihoods)")
parser.add_argument("--log_level", metavar="LEVEL", default=None,
    help="Structured-log level for the wgsassign_jax logger (default WARNING; "
         "also via WGSA_LOG_LEVEL)")


def main(argv=None):
    args = parser.parse_args(argv)
    n_args = len(sys.argv) - 1 if argv is None else len(argv)
    if n_args < 1:
        parser.print_help()
        sys.exit()
    print("WGSassign (wgsassign-jax " + __version__ + ")")
    print("Population-assignment engine on JAX.\n")

    if args.loo_downsampled_beagle and not args.loo:
        raise ValueError(
            "The --loo_downsampled_beagle option requires that --loo is also specified."
        )
    if args.em_checkpoint and not args.loo:
        raise ValueError(
            "--em_checkpoint checkpoints the LOO EM and requires --loo "
            "(the reference-AF EM is not checkpointed)"
        )

    import numpy as np

    from wgsassign_jax.io import writers
    from wgsassign_jax.io.beagle import filter_sites_to_common, read_beagle
    from wgsassign_jax.io.ids import read_ids
    from wgsassign_jax.parallel.mesh import make_runtime, maybe_initialize_distributed
    from wgsassign_jax.obs.profiling import maybe_profile, RunTimer

    from wgsassign_jax.obs.log import setup_logging

    setup_logging(args.log_level)
    maybe_initialize_distributed()
    from wgsassign_jax.parallel.mesh import enable_compilation_cache

    enable_compilation_cache()
    import jax

    if jax.process_count() > 1 and jax.process_index() != 0:
        # multi-host: one process owns stdout (file writers are guarded
        # inside io.writers); warnings/errors still reach stderr
        sys.stdout = open(os.devnull, "w")

    # provenance log (reference WGSassign.py:127-141)
    writers.write_args_file(args.out, args, parser.parse_args([]))

    if args.debug_checks:
        jax.config.update("jax_debug_nans", True)
    devices = jax.devices()
    if args.devices is not None:
        if jax.process_count() > 1:
            raise ValueError(
                "--devices cannot be combined with a multi-host run (the "
                "mesh must span every process's devices)"
            )
        devices = devices[: args.devices]
    runtime = make_runtime(devices, debug_checks=args.debug_checks)
    print(
        f"Mesh: {runtime.n_devices} device(s) on "
        f"{devices[0].platform} across {jax.process_count()} process(es); "
        f"SNP-axis data parallel; engine path: {runtime.engine}."
    )
    timer = RunTimer()

    with maybe_profile(args.profile):
        _dispatch(args, runtime, timer, np, writers, read_beagle, read_ids,
                  filter_sites_to_common)
    timer.report()


def _dispatch(args, runtime, timer, np, writers, read_beagle, read_ids,
              filter_sites_to_common):
    from wgsassign_jax.models.common import to_device

    import jax

    beagle = None
    cohort = None
    downsampled = None
    downsampled_cohort = None
    multi_process = jax.process_count() > 1

    # --threads: host parser thread cap (0 = all cores, matching the native
    # loader's default); device parallelism is the mesh, not this flag
    n_threads = args.threads if args.threads and args.threads > 0 else None

    if args.beagle is not None and args.stream_ingest is not None:
        from wgsassign_jax.models.common import stream_to_device

        keep_full = keep_ds = None
        if args.loo_downsampled_beagle:
            # streamed form of the reference's downsampled-LOO site
            # intersection: one hash-scan pass per file (O(M)*8 bytes of
            # uint64 per host, no O(M) Python strings), then masked
            # streaming — the GL matrices still never exist on host
            from wgsassign_jax.io.beagle import (
                scan_header_samples,
                scan_site_hashes,
                site_intersection_masks_hashed,
            )

            if (scan_header_samples(args.beagle)
                    != scan_header_samples(args.loo_downsampled_beagle)):
                raise ValueError(
                    "Sample names in downsampled Beagle file do not match original."
                )
            print("Scanning site names for the downsampled intersection.")
            with timer.phase("parse"):
                keep_full, keep_ds = site_intersection_masks_hashed(
                    scan_site_hashes(args.beagle),
                    scan_site_hashes(args.loo_downsampled_beagle),
                )
        print("Streaming Beagle file to device in site blocks.")
        with timer.phase("parse"):
            cohort, beagle, _ = stream_to_device(
                args.beagle, runtime,
                site_multiple=args.partition_sites,
                block_rows=args.stream_ingest or None,
                n_threads=n_threads,
                keep_mask=keep_full,
            )
        print(
            f"Loaded {cohort.m_real} sites and {beagle.n_inds} individuals "
            "(streamed; GL matrix resident on device only)."
        )
        _print_preview("sample_names", beagle.sample_names)
        if args.loo_downsampled_beagle:
            print("Streaming the downsampled Beagle file.")
            with timer.phase("parse"):
                downsampled_cohort, _ds_meta, _ = stream_to_device(
                    args.loo_downsampled_beagle, runtime,
                    site_multiple=args.partition_sites,
                    block_rows=args.stream_ingest or None,
                    n_threads=n_threads,
                    keep_mask=keep_ds,
                )
    elif args.beagle is not None:
        if multi_process and args.loo_downsampled_beagle:
            from wgsassign_jax.io.beagle import sharded_downsampled_pair

            print("Parsing Beagle files (per-host row shards over the "
                  "global site intersection).")
            with timer.phase("parse"):
                beagle, downsampled = sharded_downsampled_pair(
                    args.beagle, args.loo_downsampled_beagle, runtime,
                    site_multiple=args.partition_sites, n_threads=n_threads,
                )
            print(
                f"Loaded {beagle.n_sites} common sites and {beagle.n_inds} "
                f"individuals ({beagle.hi - beagle.lo} sites on this host)."
            )
        elif multi_process:
            from wgsassign_jax.io.beagle import read_beagle_sharded

            print("Parsing Beagle file (per-host row shards).")
            with timer.phase("parse"):
                beagle = read_beagle_sharded(
                    args.beagle, runtime, site_multiple=args.partition_sites,
                    n_threads=n_threads,
                )
            print(
                f"Loaded {beagle.n_sites} sites and {beagle.n_inds} "
                f"individuals ({beagle.hi - beagle.lo} sites on this host)."
            )
        else:
            print("Parsing Beagle file.")
            with timer.phase("parse"):
                beagle = read_beagle(args.beagle, n_threads=n_threads)
            print(
                f"Loaded {beagle.n_sites} sites and {beagle.n_inds} individuals."
            )
            _print_preview("sample_names", beagle.sample_names)
            _print_preview("site_names", beagle.site_names)

    if (args.loo_downsampled_beagle is not None and not multi_process
            and args.stream_ingest is None):
        print("Parsing the optional downsampled Beagle file.")
        with timer.phase("parse"):
            downsampled = read_beagle(
                args.loo_downsampled_beagle, n_threads=n_threads
            )
        print(
            f"Loaded optional downsampled data set with {downsampled.n_sites} "
            f"sites and {downsampled.n_inds} individuals."
        )
        if beagle.sample_names != downsampled.sample_names:
            raise ValueError("Sample names in downsampled Beagle file do not match original.")
        print("Retaining only sites from the reference that are in the downsampled beagle file:")
        beagle = filter_sites_to_common(beagle, downsampled.site_names)
        print("Removing sites from downsampled set that were not in the reference (should not occur...):")
        downsampled = filter_sites_to_common(downsampled, beagle.site_names)
        if beagle.site_names != downsampled.site_names:
            raise ValueError("Site names in full and downsampled Beagle do not match after filtering.")

    if beagle is not None and cohort is None:
        with timer.phase("h2d"):
            cohort = to_device(beagle, runtime, site_multiple=args.partition_sites)

    # ---- reference AF (+ ne_obs, + loo) -----------------------------------
    if args.get_reference_af:
        from wgsassign_jax.models.reference_af import estimate_reference_af

        print("Parsing reference population ID file.")
        assert os.path.isfile(args.pop_af_IDs), "Reference population ID file does not exist!!"
        popmap = read_ids(args.pop_af_IDs)
        with timer.phase("reference_af"):
            res = estimate_reference_af(
                beagle, popmap, args.maf_iter, args.maf_tole, cohort=cohort,
            )
        em_secs = timer.totals["reference_af"]
        total_updates = float(
            beagle.n_sites * sum(
                int(it) * int(sz)
                for it, sz in zip(res.iters, popmap.pop_sizes)
            )
        )
        print(f"EM throughput: {total_updates / max(em_secs, 1e-9):.3g} "
              "site-individual GL updates/s")
        for pop, it, conv in zip(res.pops, res.iters, res.converged):
            status = f"converged at iteration: {it}" if conv else \
                     f"did not converge within {args.maf_iter} iterations"
            print(f"EM (MAF) population {pop}: {status}")
        writers.write_pop_af(args.out, res.af)
        print(f"Saved reference population allele frequencies as {args.out}"
              ".pop_af.npy (Binary - np.float32)\n")
        print(f"Column order of populations is: {res.pops}")
        writers.write_pop_names(args.out, res.pops)
        print(f"Saved reference population names as {args.out}.pop_names.txt\n")

        if args.ne_obs:
            from wgsassign_jax.models.ne import effective_sample_sizes

            print("Estimating Fisher information.")
            with timer.phase("ne"):
                ne = effective_sample_sizes(beagle, res.af, popmap, cohort=cohort)
            writers.write_ne_outputs(args.out, ne.f_obs, ne.ne_obs, res.pops)
            print(f"Saved observed Fisher information as {args.out}.fisher_obs.npy")
            print(f"Saved per-locus effective sample sizes as {args.out}.ne_obs.npy")
            print(f"Saved population effective sample sizes as {args.out}.ne_obs.txt")
            print("Estimating individual effective sample sizes.")
            writers.write_ne_ind(args.out, ne.ne_ind)
            print(f"Saved individual effective sample sizes as {args.out}.ne_ind.txt")

        if args.loo:
            from wgsassign_jax.models.loo import leave_one_out

            print("Performing leave-one-out cross validation.")
            with timer.phase("loo"):
                loo_res = leave_one_out(
                    beagle,
                    res.af,
                    popmap,
                    args.maf_iter,
                    args.maf_tole,
                    downsampled=downsampled,
                    num_partitions=args.partition_sites,
                    cohort=cohort,
                    downsampled_cohort=downsampled_cohort,
                    compat_af_mutation=not args.loo_clean_af,
                    verbose=True,
                    f64_sums=not args.f32_sums,
                    checkpoint_path=(args.out + ".loo.ckpt"
                                     if args.em_checkpoint else None),
                )
            loo_secs = timer.totals["loo"]
            sizes_of = dict(zip(popmap.pops, popmap.pop_sizes))
            # under --stream_ingest with a downsampled filter the EM ran on
            # the intersected site count (cohort.m_real), not the raw file
            # row count
            loo_m = cohort.m_real if cohort is not None else beagle.n_sites
            pairwise_updates = float(loo_m) * sum(
                int(it) * int(sizes_of[lab])
                for it, lab in zip(loo_res.iters, popmap.pop_labels)
            )
            print(f"LOO EM throughput: {pairwise_updates / max(loo_secs, 1e-9):.3g} "
                  "pairwise site-member updates/s")
            suffix = ("_downsampled"
                      if (downsampled is not None
                          or downsampled_cohort is not None) else "")
            outfile = f"{args.out}.pop_like_LOO{suffix}.tsv"
            writers.write_assignment_matrix(
                outfile, loo_res.ll, beagle.sample_names, list(res.pops),
                print_part_column=False, sample_locations=popmap.pop_labels,
                doing_LOO=True,
            )
            print(f"Saved leave-one-out cross validation log likelihoods as {outfile}")
            if args.partition_sites > 1:
                partfile = (f"{args.out}.pop_like_LOO{suffix}_partitions_"
                            f"{args.partition_sites}.tsv.gz")
                writers.write_assignment_matrix(
                    partfile, loo_res.parts, beagle.sample_names, list(res.pops),
                    partition_count=args.partition_sites, print_part_column=True,
                    sample_locations=popmap.pop_labels, doing_LOO=True,
                )
                print(f"Saved partitioned LOO log likelihoods as {partfile}")
            print(f"Column order of populations is: {res.pops}")

    # ---- assignment likelihoods -------------------------------------------
    if args.get_pop_like:
        from wgsassign_jax.models.assign import assignment_loglikelihoods

        print("Parsing population allele frequency file.")
        assert os.path.isfile(args.pop_af_file), "Population allele frequency file does not exist!!"
        af = np.load(args.pop_af_file)
        print("Calculating likelihood of population assignment")
        print(f"{beagle.n_inds} individuals to assign to {af.shape[1]} populations")
        with timer.phase("pop_like"):
            ll = assignment_loglikelihoods(
                beagle, af, cohort=cohort, f64_sums=not args.f32_sums
            )
        writers.write_loglike_txt(args.out, ll)
        print(f"Saved population assignment log likelihoods as {args.out}.pop_like.txt (text)")

    # ---- z-scores ----------------------------------------------------------
    if args.get_reference_z_score or args.get_assignment_z_score:
        from wgsassign_jax.io.ad import read_allele_depths

        print("Parsing population ID file.")
        assert os.path.isfile(args.pop_af_IDs), "Population ID file does not exist!!"
        popmap = read_ids(args.pop_af_IDs)
        print("Parsing individual allele depths file.")
        assert os.path.isfile(args.ind_ad_file), "Individual allele depths file does not exist!"
        z_m = cohort.m_real if cohort is not None else beagle.n_sites
        ad = read_allele_depths(
            args.ind_ad_file, n_sites=z_m, n_inds=beagle.n_inds
        )
        assert os.path.isfile(args.pop_names), "Population names file does not exist!!"
        from wgsassign_jax.io.ids import read_pop_names

        pops = read_pop_names(args.pop_names)
        n = beagle.n_inds
        assert n == popmap.n_inds, \
            "Number of individuals in beagle and reference ID file do not match!"
        threshold = args.allele_count_threshold or 0
        assert threshold >= 0, "Allele count threshold needs to be greater than/equal to 0!"
        ind_start = args.ind_start or 0
        ind_end = args.ind_end if args.ind_end is not None else n
        assert 0 <= ind_start < n and 0 < ind_end <= n and ind_start < ind_end, \
            "Individual index range out of bounds!"

        if args.get_reference_z_score:
            from wgsassign_jax.models.zscore import reference_z_scores

            with timer.phase("zscore"):
                res = reference_z_scores(
                    beagle, ad, popmap, ind_start, ind_end, threshold,
                    args.single_read_threshold, args.maf_iter, args.maf_tole,
                    cohort=cohort, verbose=True,
                    error_rate=args.zscore_error_rate,
                )
            writers.write_z_scores(args.out, res.z, reference_mode=True)
            print(f"Saved {len(res.z)} individual z-scores as {args.out}.reference_z_ind.txt (text)")

        if args.get_assignment_z_score:
            from wgsassign_jax.models.zscore import assignment_z_scores

            with timer.phase("zscore"):
                res = assignment_z_scores(
                    beagle, ad, popmap.pop_labels, np.load(args.pop_af_file)
                    if args.pop_af_file else _require_af(args), pops,
                    ind_start, ind_end, threshold, args.single_read_threshold,
                    cohort=cohort, verbose=True,
                    error_rate=args.zscore_error_rate,
                )
            writers.write_z_scores(args.out, res.z, reference_mode=False)
            print(f"Saved {len(res.z)} individual z-scores as {args.out}.z_ind.txt (text)")

    # ---- mixture proportions ----------------------------------------------
    if args.get_em_mix or args.get_mcmc_mix:
        from wgsassign_jax.models.mixture import (
            em_mixture,
            format_mixture_output,
            mcmc_mixture,
        )

        print("Parsing population assignment likelihood file.")
        assert os.path.isfile(args.pop_like), "Population assignment log likelihood file does not exist!!"
        assert os.path.isfile(args.pop_like_IDs), "ID file does not exist!!"
        ll_mat = np.atleast_2d(np.loadtxt(args.pop_like))
        # read_ids handles the single-row case a raw loadtxt[:, 1] would
        # IndexError on
        harvest_labels = read_ids(args.pop_like_IDs).pop_labels
        if args.get_em_mix:
            print("Calculating mixture proportions with EM")
            with timer.phase("mixture"):
                res = em_mixture(
                    ll_mat, harvest_labels, args.mixture_iter, stable=args.stable_mix
                )
            writers.write_mixture(args.out, format_mixture_output(res), mcmc=False)
            print(f"Saved EM mixture proportions {args.out}.em_mix.txt (text)")
        if args.get_mcmc_mix:
            print("Calculating mixture proportions with MCMC")
            with timer.phase("mixture"):
                res = mcmc_mixture(
                    ll_mat, harvest_labels, args.mixture_iter, seed=args.mcmc_seed,
                    posterior_mean=not args.mcmc_last_draw,
                )
            writers.write_mixture(args.out, format_mixture_output(res), mcmc=True)
            print(f"Saved MCMC mixture proportions {args.out}.mcmc_mix.txt (text)")


def _require_af(args):
    raise ValueError("--get_assignment_z_score requires --pop_af_file")


def _print_preview(name, items):
    n = len(items)
    if n <= 4:
        preview = ", ".join(items)
    else:
        preview = ", ".join(items[:2]) + ", ..., " + ", ".join(items[-2:])
    label = "samples" if "sample" in name else "sites"
    print(f"{name}: {n} {label} total: {preview}")


if __name__ == "__main__":
    main()
