"""End-to-end CLI tests: the README workflows on the bundled amre data,
checked against the golden fixtures and the documented file formats."""

import gzip

import numpy as np
import pandas as pd
import pytest

from conftest import (
    BREEDING_AD,
    BREEDING_BEAGLE,
    BREEDING_IDS,
    BREEDING_SUBSET_BEAGLE,
    GOLDEN_DIR,
    NONBREEDING_AD,
    NONBREEDING_BEAGLE,
    NONBREEDING_IDS,
)

from wgsassign_jax.cli import main


def run_cli(tmp_path, *flags):
    out = tmp_path / "run"
    main(["-o", str(out), *map(str, flags)])
    return out


def test_reference_af_workflow(tmp_path):
    out = run_cli(
        tmp_path,
        "--beagle", BREEDING_BEAGLE,
        "--pop_af_IDs", BREEDING_IDS,
        "--get_reference_af",
    )
    golden = np.load(GOLDEN_DIR / "ref_af.npz", allow_pickle=True)
    af = np.load(str(out) + ".pop_af.npy")
    assert af.dtype == np.float32
    np.testing.assert_allclose(af, golden["af"], atol=2e-5)
    pops = np.loadtxt(str(out) + ".pop_names.txt", dtype=str)
    assert list(pops) == list(golden["pops"])
    # provenance .args file exists and lists non-default options
    args_text = open(str(out) + ".args").read()
    assert "WGSassign" in args_text and "get_reference_af" in args_text


def test_full_composed_workflow(tmp_path):
    """--get_reference_af --ne_obs --loo in one run, like the reference."""
    out = run_cli(
        tmp_path,
        "--beagle", BREEDING_BEAGLE,
        "--pop_af_IDs", BREEDING_IDS,
        "--get_reference_af", "--ne_obs", "--loo",
    )
    ne_golden = np.load(GOLDEN_DIR / "ne.npz")
    np.testing.assert_allclose(
        np.load(str(out) + ".ne_obs.npy"), ne_golden["ne_obs"], rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        np.load(str(out) + ".fisher_obs.npy"), ne_golden["f_obs"], rtol=2e-4, atol=2e-3
    )
    ne_txt = np.loadtxt(str(out) + ".ne_obs.txt", dtype=str)
    assert ne_txt.shape == (2, 5)
    ne_ind = np.loadtxt(str(out) + ".ne_ind.txt")
    np.testing.assert_allclose(ne_ind, ne_golden["ne_ind"], rtol=2e-4, atol=2e-4)

    loo_golden = np.load(GOLDEN_DIR / "loo.npz")
    df = pd.read_csv(str(out) + ".pop_like_LOO.tsv", sep="\t")
    assert list(df.columns) == [
        "sample", "source_pop",
        "Newfoundland", "Northeast", "Northwest", "South", "SouthDakota",
    ]
    vals = df.iloc[:, 2:].to_numpy()
    np.testing.assert_allclose(vals, loo_golden["ll"], rtol=1e-5, atol=2e-3)


def test_loo_partitions_and_downsampled(tmp_path):
    out = run_cli(
        tmp_path,
        "--beagle", BREEDING_BEAGLE,
        "--pop_af_IDs", BREEDING_IDS,
        "--loo_downsampled_beagle", BREEDING_SUBSET_BEAGLE,
        "--get_reference_af", "--loo", "--partition_sites", 4,
    )
    golden = np.load(GOLDEN_DIR / "loo_downsampled.npz")
    df = pd.read_csv(str(out) + ".pop_like_LOO_downsampled.tsv", sep="\t")
    np.testing.assert_allclose(
        df.iloc[:, 2:].to_numpy(), golden["ll"], rtol=1e-5, atol=2e-3
    )
    partfile = str(out) + ".pop_like_LOO_downsampled_partitions_4.tsv.gz"
    with gzip.open(partfile, "rt") as f:
        dfp = pd.read_csv(f, sep="\t")
    assert list(dfp.columns[:3]) == ["sample", "source_pop", "data_part"]
    assert len(dfp) == 85 * 4
    np.testing.assert_allclose(
        dfp.iloc[:, 3:].to_numpy(), golden["parts"], rtol=1e-4, atol=2e-3
    )


def test_pop_like_workflow(tmp_path):
    np.save(tmp_path / "af.npy", np.load(GOLDEN_DIR / "ref_af.npz")["af"])
    out = run_cli(
        tmp_path,
        "--beagle", NONBREEDING_BEAGLE,
        "--pop_af_file", tmp_path / "af.npy",
        "--get_pop_like",
    )
    golden = np.load(GOLDEN_DIR / "pop_like.npz")
    ll = np.loadtxt(str(out) + ".pop_like.txt")
    np.testing.assert_allclose(ll, golden["ll"], rtol=1e-6, atol=2e-4)


def test_mixture_workflow(tmp_path):
    np.savetxt(
        tmp_path / "pop_like.txt",
        np.load(GOLDEN_DIR / "pop_like.npz")["ll"],
        fmt="%.7f",
    )
    out = run_cli(
        tmp_path,
        "--pop_like", tmp_path / "pop_like.txt",
        "--pop_like_IDs", NONBREEDING_IDS,
        "--get_em_mix", "--get_mcmc_mix", "--mcmc_seed", 3,
    )
    golden = np.load(GOLDEN_DIR / "em_mix.npz", allow_pickle=True)
    em = np.loadtxt(str(out) + ".em_mix.txt", dtype=str)
    assert list(em[:, 0]) == list(golden["harvest"])
    np.testing.assert_allclose(
        em[:, 1:].astype(float), golden["pi"], rtol=1e-4, atol=1e-5
    )
    mc = np.loadtxt(str(out) + ".mcmc_mix.txt", dtype=str)
    assert mc.shape == em.shape
    assert np.isfinite(mc[:, 1:].astype(float)).all()


def test_zscore_workflows(tmp_path):
    np.save(tmp_path / "af.npy", np.load(GOLDEN_DIR / "ref_af.npz")["af"])
    pops = np.load(GOLDEN_DIR / "ref_af.npz", allow_pickle=True)["pops"]
    np.savetxt(tmp_path / "pops.txt", pops, fmt="%s")
    thr = int(np.load(GOLDEN_DIR / "zscore_reference.npz")["threshold"])

    out = run_cli(
        tmp_path,
        "--beagle", BREEDING_BEAGLE,
        "--pop_af_IDs", BREEDING_IDS,
        "--pop_names", tmp_path / "pops.txt",
        "--ind_ad_file", BREEDING_AD,
        "--allele_count_threshold", thr,
        "--get_reference_z_score",
        "--ind_start", 0, "--ind_end", 5,
    )
    golden = np.load(GOLDEN_DIR / "zscore_reference.npz")
    z = np.loadtxt(str(out) + ".reference_z_ind.txt")
    np.testing.assert_allclose(z, golden["z"][:5], rtol=2e-3, atol=2e-3)

    out2 = run_cli(
        tmp_path,
        "--beagle", NONBREEDING_BEAGLE,
        "--pop_af_IDs", GOLDEN_DIR / "nonbreeding_assigned_ids.txt",
        "--pop_af_file", tmp_path / "af.npy",
        "--pop_names", tmp_path / "pops.txt",
        "--ind_ad_file", NONBREEDING_AD,
        "--allele_count_threshold", thr,
        "--get_assignment_z_score",
        "--ind_end", 6,
    )
    golden2 = np.load(GOLDEN_DIR / "zscore_assignment.npz")
    z2 = np.loadtxt(str(out2) + ".z_ind.txt")
    np.testing.assert_allclose(z2, golden2["z"][:6], rtol=2e-3, atol=2e-3)


def test_downsampled_requires_loo(tmp_path):
    with pytest.raises(ValueError, match="requires that --loo"):
        run_cli(tmp_path, "--beagle", BREEDING_BEAGLE,
                "--loo_downsampled_beagle", BREEDING_SUBSET_BEAGLE)


def test_downsampled_sample_name_mismatch(tmp_path):
    """Downsampled Beagle with different sample names must be rejected
    (reference WGSassign.py:183-184)."""
    import gzip as _gzip

    bad = tmp_path / "renamed.beagle.gz"
    with _gzip.open(BREEDING_SUBSET_BEAGLE, "rt") as f:
        lines = f.readlines()
    header = lines[0].replace("Ind0", "IndX")
    with _gzip.open(bad, "wt") as f:
        f.writelines([header] + lines[1:])
    with pytest.raises(ValueError, match="Sample names in downsampled"):
        run_cli(
            tmp_path,
            "--beagle", BREEDING_BEAGLE,
            "--pop_af_IDs", BREEDING_IDS,
            "--loo_downsampled_beagle", bad,
            "--get_reference_af", "--loo",
        )


def test_ind_start_zero_accepted(tmp_path):
    """Documented deviation: --ind_start 0 works (the reference rejected 0
    despite claiming 0-indexing)."""
    np.save(tmp_path / "af.npy", np.load(GOLDEN_DIR / "ref_af.npz")["af"])
    pops = np.load(GOLDEN_DIR / "ref_af.npz", allow_pickle=True)["pops"]
    np.savetxt(tmp_path / "pops.txt", pops, fmt="%s")
    out = run_cli(
        tmp_path,
        "--beagle", NONBREEDING_BEAGLE,
        "--pop_af_IDs", GOLDEN_DIR / "nonbreeding_assigned_ids.txt",
        "--pop_af_file", tmp_path / "af.npy",
        "--pop_names", tmp_path / "pops.txt",
        "--ind_ad_file", NONBREEDING_AD,
        "--allele_count_threshold", 5,
        "--get_assignment_z_score",
        "--ind_start", 0, "--ind_end", 2,
    )
    z = np.loadtxt(str(out) + ".z_ind.txt")
    assert np.isfinite(z).all()


def test_threads_flag_reaches_native_parser(tmp_path, monkeypatch):
    """--threads must be forwarded to the native Beagle parser
    (docs/migration.md documents it as the host parser thread cap)."""
    import wgsassign_jax._native as native
    from wgsassign_jax.io.beagle import _read_beagle_python

    seen = {}

    def fake_read(path, n_threads=None, row_range=None):
        seen["n_threads"] = n_threads
        return _read_beagle_python(path, row_range=row_range)

    monkeypatch.setattr(native, "read_beagle_native", fake_read)
    run_cli(
        tmp_path,
        "--beagle", BREEDING_BEAGLE,
        "--pop_af_IDs", BREEDING_IDS,
        "--get_reference_af",
        "-t", 3,
    )
    assert seen["n_threads"] == 3


def test_zscore_error_rate_flag(tmp_path, monkeypatch):
    """--zscore_error_rate reaches the combo-table builder (the reference
    hard-codes e=0.01, WGSassign.py:350,430)."""
    import wgsassign_jax.models.zscore as zs

    seen = {}
    real_build = zs.build_combo_tables

    def spy(gl_i, ad_i, n_threshold, single_read_threshold, e=zs.SEQ_ERROR_RATE):
        seen["e"] = e
        return real_build(gl_i, ad_i, n_threshold, single_read_threshold, e)

    monkeypatch.setattr(zs, "build_combo_tables", spy)
    np.save(tmp_path / "af.npy", np.load(GOLDEN_DIR / "ref_af.npz")["af"])
    pops = np.load(GOLDEN_DIR / "ref_af.npz", allow_pickle=True)["pops"]
    np.savetxt(tmp_path / "pops.txt", pops, fmt="%s")
    run_cli(
        tmp_path,
        "--beagle", NONBREEDING_BEAGLE,
        "--pop_af_IDs", GOLDEN_DIR / "nonbreeding_assigned_ids.txt",
        "--pop_af_file", tmp_path / "af.npy",
        "--pop_names", tmp_path / "pops.txt",
        "--ind_ad_file", NONBREEDING_AD,
        "--allele_count_threshold", 5,
        "--get_assignment_z_score",
        "--ind_end", 2,
        "--zscore_error_rate", 0.2,
    )
    assert seen["e"] == pytest.approx(0.2)


def test_mixture_single_row_ids(tmp_path):
    """A one-individual pop_like/IDs pair must not IndexError (io.ids
    handles the 1-D loadtxt case; cli reuses it)."""
    ll = np.load(GOLDEN_DIR / "pop_like.npz")["ll"][:1]
    np.savetxt(tmp_path / "pop_like.txt", ll, fmt="%.7f")
    (tmp_path / "ids.txt").write_text("Ind0\tCO\n")
    out = run_cli(
        tmp_path,
        "--pop_like", tmp_path / "pop_like.txt",
        "--pop_like_IDs", tmp_path / "ids.txt",
        "--get_em_mix",
    )
    em = np.loadtxt(str(out) + ".em_mix.txt", dtype=str)
    assert em[0] == "CO"
    pi = em[1:].astype(float)
    assert pi.shape == (ll.shape[1],) and np.isfinite(pi).all()


def test_em_checkpoint_requires_loo(tmp_path):
    """--em_checkpoint checkpoints the LOO EM only; without --loo it would
    do nothing, so it is rejected instead of silently ignored."""
    with pytest.raises(ValueError, match="requires --loo"):
        run_cli(tmp_path, "--beagle", BREEDING_BEAGLE,
                "--pop_af_IDs", BREEDING_IDS, "--get_reference_af",
                "--em_checkpoint")


def test_em_checkpoint_loo_workflow(tmp_path):
    """With --loo the LOO checkpoints are written, used and removed; the
    outputs match a run without checkpoints."""
    out = run_cli(tmp_path, "--beagle", BREEDING_BEAGLE,
                  "--pop_af_IDs", BREEDING_IDS, "--get_reference_af", "--loo",
                  "--em_checkpoint")
    loo_golden = np.load(GOLDEN_DIR / "loo.npz")
    df = pd.read_csv(str(out) + ".pop_like_LOO.tsv", sep="\t")
    np.testing.assert_allclose(df.iloc[:, 2:].to_numpy(), loo_golden["ll"],
                               rtol=1e-5, atol=2e-3)
    assert not list(tmp_path.glob("*.ckpt*"))
