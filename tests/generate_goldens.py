"""Generate the seeded test fixtures and their golden outputs.

Run from the repo root:  python tests/generate_goldens.py

Step 1 writes ``tests/data/``: a synthetic cohort with the shapes of the
upstream amre example (449 sites x 85 breeding individuals in five
reference populations of 14/20/15/23/13, a downsampled copy of 357 of
those sites, and 34 nonbreeding individuals from three harvest sites of
12/10/12), with the allele depths the GLs were computed from
(``io/synth.py``).  Step 2 runs ``tests/oracle.py`` on them and writes
``tests/golden/*.npz``.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent))
sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import oracle
from conftest import (
    BREEDING_AD,
    BREEDING_BEAGLE,
    BREEDING_IDS,
    BREEDING_SUBSET_BEAGLE,
    DATA_DIR,
    NONBREEDING_AD,
    NONBREEDING_BEAGLE,
    NONBREEDING_IDS,
)
from wgsassign_jax.io.beagle import filter_sites_to_common, read_beagle, to_legacy_matrix
from wgsassign_jax.io.synth import population_afs, sample_reads, write_beagle

OUT = pathlib.Path(__file__).parent / "golden"

SEED = 20261016
M_SITES = 449
M_SUBSET = 357
REFERENCE_POPS = {"Newfoundland": 14, "Northeast": 20, "Northwest": 15,
                  "South": 23, "SouthDakota": 13}
HARVEST_SITES = {"CO": 12, "MX": 10, "TR": 12}
FST = 0.1
MEAN_DEPTH = 2.0
ERROR_RATE = 0.01

NUM_PARTITIONS = 4
Z_THRESHOLD = 5


def _write_ids(path, labels):
    with open(path, "w") as f:
        for i, lab in enumerate(labels):
            f.write(f"Ind{i}\t{lab}\n")


def make_fixtures():
    """Write the seeded cohort files under ``tests/data/``."""
    rng = np.random.default_rng(SEED)
    DATA_DIR.mkdir(exist_ok=True)
    pops = list(REFERENCE_POPS)
    pop_af = population_afs(M_SITES, len(pops), FST, rng)

    # breeding panel: individuals in shuffled population order, so the LOO
    # in-place AF quirk sees interleaved members
    labels = np.repeat(pops, list(REFERENCE_POPS.values()))
    labels = labels[rng.permutation(labels.size)]
    pop_of = np.searchsorted(pops, labels)
    gl, ad = sample_reads(pop_af, pop_of, rng, MEAN_DEPTH, ERROR_RATE)
    write_beagle(str(BREEDING_BEAGLE), gl)
    _write_ids(BREEDING_IDS, labels)
    np.savetxt(BREEDING_AD, ad, fmt="%d")

    # downsampled copy: a sorted 80% site subset, each read kept with
    # probability 1/2 and the GLs recomputed from the thinned reads
    keep = np.sort(rng.choice(M_SITES, size=M_SUBSET, replace=False))
    major = rng.binomial(ad[keep, 0::2], 0.5)
    minor = rng.binomial(ad[keep, 1::2], 0.5)
    from wgsassign_jax.io.synth import _gl_table

    table = _gl_table(int(max(major.max(), minor.max(), 1)), ERROR_RATE)
    gl_ds = table[major, minor]
    write_beagle(str(BREEDING_SUBSET_BEAGLE), gl_ds, sites=keep)

    # nonbreeding cohort: each harvest site draws its individuals'
    # source populations from its own mixture
    harvest = np.repeat(list(HARVEST_SITES), list(HARVEST_SITES.values()))
    mix = rng.dirichlet(np.ones(len(pops)), size=len(HARVEST_SITES))
    site_of = np.searchsorted(list(HARVEST_SITES), harvest)
    src = np.array([rng.choice(len(pops), p=mix[s]) for s in site_of])
    gl_nb, ad_nb = sample_reads(pop_af, src, rng, MEAN_DEPTH, ERROR_RATE)
    write_beagle(str(NONBREEDING_BEAGLE), gl_nb)
    _write_ids(NONBREEDING_IDS, harvest)
    np.savetxt(NONBREEDING_AD, ad_nb, fmt="%d")


def main():
    print("[0/7] seeded fixtures ...")
    make_fixtures()
    OUT.mkdir(exist_ok=True)
    breeding = read_beagle(str(BREEDING_BEAGLE))
    L = to_legacy_matrix(breeding)
    ids = np.loadtxt(BREEDING_IDS, delimiter="\t", dtype=str)
    labels = ids[:, 1]

    print("[1/7] reference AF ...")
    af, pops = oracle.reference_af(L, labels)
    np.savez(OUT / "ref_af.npz", af=af, pops=pops)

    print("[2/7] assignment log-likelihoods (nonbreeding) ...")
    nonbreeding = read_beagle(str(NONBREEDING_BEAGLE))
    L_nb = to_legacy_matrix(nonbreeding)
    ll_nb = oracle.assign_ll(L_nb, af)
    np.savez(OUT / "pop_like.npz", ll=ll_nb, pops=pops)

    print("[3/7] LOO (+partitions) ...")
    ll_loo, parts_loo = oracle.loo(
        L, af, labels, num_partitions=NUM_PARTITIONS
    )
    np.savez(
        OUT / "loo.npz", ll=ll_loo, parts=parts_loo, num_partitions=NUM_PARTITIONS
    )

    print("[4/7] LOO with downsampled beagle ...")
    subset = read_beagle(str(BREEDING_SUBSET_BEAGLE))
    b_f = filter_sites_to_common(breeding, subset.site_names)
    s_f = filter_sites_to_common(subset, b_f.site_names)
    assert b_f.site_names == s_f.site_names
    L_f = to_legacy_matrix(b_f)
    L_ds = to_legacy_matrix(s_f)
    af_ds, _ = oracle.reference_af(L_f, labels)
    ll_ds, parts_ds = oracle.loo(
        L_f, af_ds, labels, L_ds=L_ds, num_partitions=NUM_PARTITIONS
    )
    np.savez(
        OUT / "loo_downsampled.npz",
        af=af_ds,
        ll=ll_ds,
        parts=parts_ds,
        num_partitions=NUM_PARTITIONS,
        m_common=L_f.shape[0],
    )

    print("[5/7] Fisher / Ne ...")
    f_obs, ne_obs, ne_ind = oracle.fisher_ne(L, af, labels)
    np.savez(OUT / "ne.npz", f_obs=f_obs, ne_obs=ne_obs, ne_ind=ne_ind)

    print("[6/7] z-scores ...")
    ad_b = np.loadtxt(BREEDING_AD, dtype=np.int32)
    z_ref = np.empty(L.shape[1] // 2, dtype=np.float32)
    loci_ref = np.empty(L.shape[1] // 2, dtype=np.int32)
    for i in range(L.shape[1] // 2):
        z_ref[i], loci_ref[i] = oracle.zscore_individual(
            L, ad_b, labels, i, n_threshold=Z_THRESHOLD
        )
    np.savez(
        OUT / "zscore_reference.npz", z=z_ref, loci=loci_ref, threshold=Z_THRESHOLD
    )

    ad_nb = np.loadtxt(NONBREEDING_AD, dtype=np.int32)
    assigned = pops[np.argmax(ll_nb, axis=1)]
    np.savetxt(
        OUT / "nonbreeding_assigned_ids.txt",
        np.stack([np.array(nonbreeding.sample_names), assigned], axis=1),
        fmt="%s",
        delimiter="\t",
    )
    z_as = np.empty(L_nb.shape[1] // 2, dtype=np.float32)
    loci_as = np.empty(L_nb.shape[1] // 2, dtype=np.int32)
    for i in range(L_nb.shape[1] // 2):
        z_as[i], loci_as[i] = oracle.zscore_individual(
            L_nb, ad_nb, assigned, i, af=af, pops=pops, n_threshold=Z_THRESHOLD
        )
    np.savez(
        OUT / "zscore_assignment.npz", z=z_as, loci=loci_as, threshold=Z_THRESHOLD
    )

    print("[7/7] mixture EM ...")
    nb_ids = np.loadtxt(NONBREEDING_IDS, delimiter="\t", dtype=str)
    harvest, pi = oracle.em_mix(ll_nb.astype(np.float64), nb_ids[:, 1])
    np.savez(OUT / "em_mix.npz", harvest=harvest, pi=pi)
    print("mixture pi:\n", pi)
    print("done; fixtures in", OUT)


if __name__ == "__main__":
    main()
