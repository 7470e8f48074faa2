import numpy as np
import pytest

from conftest import GOLDEN_DIR

from wgsassign_jax.io.beagle import filter_sites_to_common, read_beagle
from wgsassign_jax.models.loo import leave_one_out, loo_af_column_index
from wgsassign_jax.models.reference_af import estimate_reference_af

from conftest import BREEDING_SUBSET_BEAGLE


def test_loo_matches_golden(breeding, breeding_ids):
    golden = np.load(GOLDEN_DIR / "loo.npz")
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    res = leave_one_out(
        breeding, af, breeding_ids, num_partitions=int(golden["num_partitions"])
    )
    np.testing.assert_allclose(res.ll, golden["ll"], rtol=1e-6, atol=3e-4)
    np.testing.assert_array_equal(
        res.ll.argmax(axis=1), golden["ll"].argmax(axis=1)
    )
    np.testing.assert_allclose(res.parts, golden["parts"], rtol=1e-5, atol=3e-4)
    assert res.converged.all()


def test_loo_downsampled_matches_golden(breeding, breeding_ids):
    golden = np.load(GOLDEN_DIR / "loo_downsampled.npz")
    subset = read_beagle(str(BREEDING_SUBSET_BEAGLE))
    b_f = filter_sites_to_common(breeding, subset.site_names)
    s_f = filter_sites_to_common(subset, b_f.site_names)
    assert b_f.n_sites == int(golden["m_common"])
    res_af = estimate_reference_af(b_f, breeding_ids)
    np.testing.assert_allclose(res_af.af, golden["af"], rtol=0, atol=2e-5)
    res = leave_one_out(
        b_f,
        golden["af"],
        breeding_ids,
        downsampled=s_f,
        num_partitions=int(golden["num_partitions"]),
    )
    np.testing.assert_allclose(res.ll, golden["ll"], rtol=1e-6, atol=3e-4)
    np.testing.assert_allclose(res.parts, golden["parts"], rtol=1e-5, atol=3e-4)


def test_loo_af_column_index_compat(breeding_ids):
    """The in-place-mutation AF selection (SURVEY §2.5): own pop -> own LOO
    column; foreign pop -> last preceding member's LOO column, else full."""
    idx = loo_af_column_index(breeding_ids, compat_af_mutation=True)
    n, k = breeding_ids.n_inds, breeding_ids.n_pops
    for j in range(k):
        members = breeding_ids.members_of(breeding_ids.pops[j])
        first = members.min()
        for i in range(n):
            if breeding_ids.pop_index[i] == j:
                assert idx[i, j] == i
            elif i < first:
                assert idx[i, j] == n + j  # full-data AF fallback
            else:
                prior = members[members <= i]
                assert idx[i, j] == prior.max()


def test_loo_small_pop_raises(breeding):
    from wgsassign_jax.io.ids import population_map

    labels = ["A"] + ["B"] * 84
    pm = population_map([f"i{j}" for j in range(85)], labels)
    af = np.full((449, 2), 0.5, np.float32)
    with pytest.raises(ValueError, match="requires >= 2"):
        leave_one_out(breeding, af, pm)


def test_loo_checkpoint_resume(breeding, breeding_ids, tmp_path, monkeypatch):
    """Crash the LOO driver after two populations; the resumed run must skip
    their EMs via the per-population done files and land on identical
    results, then clean up every checkpoint file."""
    import glob

    import wgsassign_jax.models.loo as loo_mod

    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    full = loo_mod.leave_one_out(breeding, af, breeding_ids)
    ckpt = str(tmp_path / "loo.ckpt")
    orig = loo_mod._loo_group_em
    calls = []

    def crashing(*a, **kw):
        if len(calls) == 2:
            raise RuntimeError("simulated crash")
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(loo_mod, "_loo_group_em", crashing)
    with pytest.raises(RuntimeError, match="simulated crash"):
        loo_mod.leave_one_out(
            breeding, af, breeding_ids, checkpoint_path=ckpt
        )
    assert len(glob.glob(ckpt + ".pop*.done.npz")) == 2
    monkeypatch.setattr(loo_mod, "_loo_group_em", orig)
    res = loo_mod.leave_one_out(
        breeding, af, breeding_ids, checkpoint_path=ckpt
    )
    np.testing.assert_array_equal(res.iters, full.iters)
    np.testing.assert_array_equal(res.converged, full.converged)
    np.testing.assert_allclose(res.ll, full.ll, rtol=0, atol=0)
    np.testing.assert_allclose(res.parts, full.parts, rtol=0, atol=0)
    assert not glob.glob(ckpt + "*")
