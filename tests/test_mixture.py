import numpy as np

from conftest import GOLDEN_DIR, NONBREEDING_IDS

from wgsassign_jax.models.mixture import em_mixture, format_mixture_output, mcmc_mixture


def _inputs():
    ll = np.load(GOLDEN_DIR / "pop_like.npz")["ll"].astype(np.float64)
    ids = np.loadtxt(NONBREEDING_IDS, delimiter="\t", dtype=str)
    return ll, ids[:, 1]


def test_em_mix_matches_golden():
    golden = np.load(GOLDEN_DIR / "em_mix.npz", allow_pickle=True)
    ll, labels = _inputs()
    res = em_mixture(ll, labels)
    assert list(res.harvest_pops) == list(golden["harvest"])
    np.testing.assert_allclose(res.pi, golden["pi"], rtol=1e-6, atol=1e-8)


def test_stable_matches_raw_on_feasible_input():
    ll, labels = _inputs()
    raw = em_mixture(ll, labels, stable=False)
    stable = em_mixture(ll, labels, stable=True)
    np.testing.assert_allclose(raw.pi, stable.pi, rtol=1e-9, atol=1e-12)


def test_stable_survives_underflow():
    """Raw exp underflows below ~-745; the stable path must still work."""
    ll, labels = _inputs()
    shifted = ll - 5000.0  # all exp() underflow to 0
    res = em_mixture(shifted, labels, stable=True)
    assert np.isfinite(res.pi).all()
    base = em_mixture(ll, labels, stable=True)
    np.testing.assert_allclose(res.pi, base.pi, rtol=1e-9, atol=1e-12)


def test_em_mix_rows_sum_to_one():
    ll, labels = _inputs()
    res = em_mixture(ll, labels)
    np.testing.assert_allclose(res.pi.sum(axis=1), 1.0, rtol=1e-9)


def test_em_mix_two_pop_closed_form():
    """2-source mixture with individuals of certain origin: pi = proportions."""
    n1, n2 = 30, 70
    ll = np.zeros((n1 + n2, 2))
    ll[:n1, 1] = -50.0   # first block certainly source 0
    ll[n1:, 0] = -50.0   # second block certainly source 1
    res = em_mixture(ll, ["H"] * (n1 + n2), n_iter=500)
    np.testing.assert_allclose(res.pi[0], [0.3, 0.7], atol=1e-6)


def test_mcmc_mixture_reasonable():
    ll, labels = _inputs()
    em = em_mixture(ll, labels, stable=True)
    mc = mcmc_mixture(ll, labels, n_iter=400, seed=7)
    assert np.isfinite(mc.pi).all()
    np.testing.assert_allclose(mc.pi.sum(axis=1), 1.0, rtol=1e-9)
    # MCMC posterior mean should be near the EM solution
    assert np.abs(mc.pi - em.pi).max() < 0.12


def test_format_mixture_output():
    ll, labels = _inputs()
    res = em_mixture(ll, labels)
    out = format_mixture_output(res)
    assert out.shape == (3, 6)
    assert out[0, 0] == res.harvest_pops[0]
    assert abs(float(out[0, 1]) - res.pi[0, 0]) < 1e-6
