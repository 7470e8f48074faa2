import numpy as np

from conftest import GOLDEN_DIR

from wgsassign_jax.models.assign import assignment_loglikelihoods


def test_pop_like_matches_golden(nonbreeding):
    golden = np.load(GOLDEN_DIR / "pop_like.npz", allow_pickle=True)
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    ll = assignment_loglikelihoods(nonbreeding, af)
    assert ll.shape == (34, 5)
    assert ll.dtype == np.float32
    np.testing.assert_allclose(ll, golden["ll"], rtol=1e-6, atol=2e-4)
    # assignments (argmax) must be identical
    np.testing.assert_array_equal(ll.argmax(axis=1), golden["ll"].argmax(axis=1))


def test_pop_like_partitions_sum_to_total(nonbreeding):
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    ll, parts = assignment_loglikelihoods(nonbreeding, af, num_partitions=4)
    n, k = ll.shape
    resum = parts.reshape(n, 4, k).sum(axis=1)
    np.testing.assert_allclose(resum, ll, rtol=1e-5, atol=2e-3)


def test_partition_golden_structure(nonbreeding, breeding):
    """Partition p must collect exactly the sites with index % P == p."""
    af = np.load(GOLDEN_DIR / "ref_af.npz")["af"]
    _, parts = assignment_loglikelihoods(nonbreeding, af, num_partitions=4)
    # brute-force partition 0 for individual 0, pop 0
    g0 = nonbreeding.gl[:, 0, 0].astype(np.float32)
    g1 = nonbreeding.gl[:, 0, 1].astype(np.float32)
    a = af[:, 0]
    site_ll = np.log(
        g0 * (1 - a) ** 2 + g1 * 2 * a * (1 - a) + (1 - g0 - g1) * a * a
    )
    for p in range(4):
        expect = site_ll[p::4].sum(dtype=np.float64)
        np.testing.assert_allclose(parts[p, 0], expect, rtol=1e-5, atol=2e-3)


def test_debug_checks_catch_malformed_gl():
    """--debug_checks' checkify sanitizer must flag GL triples whose implied
    g2 is negative (g0+g1 > 1) — the reachable log(<=0) the fast path would
    silently fold into -inf sums (SURVEY §5)."""
    import jax
    import pytest
    from jax.experimental.checkify import JaxRuntimeError

    from wgsassign_jax.io.beagle import BeagleData
    from wgsassign_jax.models.assign import assignment_loglikelihoods
    from wgsassign_jax.parallel.mesh import make_runtime

    rng = np.random.default_rng(5)
    m, n, k = 32, 4, 2
    raw = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)
    gl = np.ascontiguousarray(raw[:, :, :2])
    af = rng.uniform(0.1, 0.9, size=(m, k)).astype(np.float32)
    rt = make_runtime(jax.devices()[:1], debug_checks=True)

    ok = BeagleData(gl.copy(), [f"I{i}" for i in range(n)],
                    [f"s{j}" for j in range(m)])
    ll = assignment_loglikelihoods(ok, af, runtime=rt)
    assert np.isfinite(ll).all()  # clean input passes the sanitizer

    bad_gl = gl.copy()
    bad_gl[3, 1] = (0.9, 0.9)  # g2 = 1 - 1.8 < 0
    af[3, 0] = 0.9  # likelihood 0.9(1-a)^2 + 1.8a(1-a) - 0.8a^2 < 0 there
    bad = BeagleData(bad_gl, ok.sample_names, ok.site_names)
    with pytest.raises(JaxRuntimeError, match="non-positive assignment"):
        assignment_loglikelihoods(bad, af, runtime=rt)
