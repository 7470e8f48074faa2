import numpy as np

from conftest import GOLDEN_DIR

from wgsassign_jax.models.ne import effective_sample_sizes


def test_ne_matches_golden(breeding, breeding_ids):
    golden = np.load(GOLDEN_DIR / "ne.npz")
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    res = effective_sample_sizes(breeding, af, breeding_ids)
    np.testing.assert_allclose(res.f_obs, golden["f_obs"], rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(res.ne_obs, golden["ne_obs"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res.ne_ind, golden["ne_ind"], rtol=2e-4, atol=2e-4)


def test_fisher_matches_autodiff(breeding, breeding_ids):
    """Observed info equals -d2/dtheta2 of the per-site log-likelihood — a
    property test the Cython reference could never write."""
    import jax
    import jax.numpy as jnp

    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    res = effective_sample_sizes(breeding, af, breeding_ids)

    def site_ll(th, g0, g1):
        g2 = 1.0 - g0 - g1
        return jnp.log(g0 * (1 - th) ** 2 + g1 * 2 * th * (1 - th) + g2 * th * th)

    d2 = jax.vmap(jax.grad(jax.grad(site_ll)), in_axes=(None, 0, 0))
    k = 0
    members = breeding_ids.members_of(breeding_ids.pops[k])
    for s in [0, 17, 311]:
        th = jnp.float32(af[s, k])
        g0 = jnp.asarray(breeding.gl[s, members, 0])
        g1 = jnp.asarray(breeding.gl[s, members, 1])
        expect = -np.sum(np.asarray(d2(th, g0, g1)))
        np.testing.assert_allclose(res.f_obs[s, k], expect, rtol=5e-3)


def test_ne_site_blocks_match(breeding, breeding_ids):
    """Streamed site-block execution must match single-block results."""
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    whole = effective_sample_sizes(breeding, af, breeding_ids)
    blocked = effective_sample_sizes(
        breeding, af, breeding_ids, site_block=64
    )
    np.testing.assert_allclose(blocked.f_obs, whole.f_obs, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(blocked.ne_obs, whole.ne_obs, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(blocked.ne_ind, whole.ne_ind, rtol=1e-5, atol=1e-6)
