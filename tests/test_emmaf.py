import numpy as np
import pytest

from conftest import GOLDEN_DIR

from wgsassign_jax.models.reference_af import estimate_reference_af


def test_reference_af_matches_golden(breeding, breeding_ids):
    golden = np.load(GOLDEN_DIR / "ref_af.npz", allow_pickle=True)
    res = estimate_reference_af(breeding, breeding_ids)
    assert list(res.pops) == list(golden["pops"])
    assert res.af.shape == golden["af"].shape
    assert res.af.dtype == np.float32
    np.testing.assert_allclose(res.af, golden["af"], rtol=0, atol=2e-5)
    assert res.converged.all()


def test_reference_af_clamped(breeding, breeding_ids):
    res = estimate_reference_af(breeding, breeding_ids)
    sizes = breeding_ids.pop_sizes
    for k in range(breeding_ids.n_pops):
        lo = 1.0 / (2.0 * (sizes[k] + 1))
        assert res.af[:, k].min() >= lo - 1e-7
        assert res.af[:, k].max() <= 1 - lo + 1e-7


def test_em_fixed_point_synthetic():
    """EM on GLs from hard genotypes at known AF recovers the empirical AF."""
    rng = np.random.default_rng(0)
    m, n = 64, 400
    true_f = rng.uniform(0.1, 0.9, size=m)
    geno = rng.binomial(2, true_f[:, None], size=(m, n))
    gl = np.zeros((m, n, 2), dtype=np.float32)
    e = 1e-3
    gl[:, :, 0] = np.where(geno == 0, 1 - e, e / 2)
    gl[:, :, 1] = np.where(geno == 1, 1 - e, e / 2)

    from wgsassign_jax.io.beagle import BeagleData
    from wgsassign_jax.io.ids import population_map

    data = BeagleData(gl, [f"i{j}" for j in range(n)], [f"s{j}" for j in range(m)])
    pm = population_map(data.sample_names, ["P"] * n)
    res = estimate_reference_af(data, pm, max_iter=300, tol=1e-6)
    emp = geno.mean(axis=1) / 2.0
    np.testing.assert_allclose(res.af[:, 0], emp, atol=5e-3)


def test_pop_count_mismatch_raises(breeding):
    from wgsassign_jax.io.ids import population_map

    pm = population_map(["a", "b"], ["X", "Y"])
    with pytest.raises(ValueError, match="do not match"):
        estimate_reference_af(breeding, pm)
