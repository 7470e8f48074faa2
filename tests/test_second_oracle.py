"""Second-oracle hardening: LOO, Fisher/Ne, and mixture cross-checked
against *serial scalar loops* that mirror the reference implementation
line by line (glassy.py:47-112 + glassy_cy.pyx:12-21, fisher_cy.pyx:12-65,
mixture.py:10-39) — independent of tests/oracle.py, so a shared oracle
misreading cannot hide a kernel bug (VERDICT r01 weak item 1)."""

import math

import numpy as np

from wgsassign_jax.io.beagle import BeagleData
from wgsassign_jax.io.ids import population_map


def _synth(m, n, seed):
    rng = np.random.default_rng(seed)
    gl = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)
    return gl[:, :, 0], gl[:, :, 1]


def _em_scalar_members(g0, g1, cols, max_iter, tol):
    """Reference emMAF over a member-column subset: float32 per-site
    accumulation (emMAF_cy.pyx:10-33), global RMSE convergence
    (emMAF.py:15-27).  Returns (f [M] float32, iterations)."""
    m = g0.shape[0]
    f = np.full(m, 0.25, dtype=np.float32)
    for it in range(max_iter):
        f_new = np.empty_like(f)
        for s in range(m):
            tmp = np.float32(0.0)
            for i in cols:
                fs = f[s]
                p0 = np.float32(g0[s, i] * (1 - fs) * (1 - fs))
                p1 = np.float32(g1[s, i] * 2 * fs * (1 - fs))
                p2 = np.float32((1 - g0[s, i] - g1[s, i]) * fs * fs)
                tmp += np.float32((p1 + 2 * p2) / (2 * (p0 + p1 + p2)))
            f_new[s] = tmp / np.float32(len(cols))
        d = f_new.astype(np.float64) - f.astype(np.float64)
        rmse = math.sqrt(np.mean(d * d))
        f = f_new
        if rmse < tol:
            return f, it + 1
    return f, max_iter


def _loglike_scalar(g0, g1, a, i):
    """glassy_cy.pyx:12-21 + the float64 reduction at glassy.py:101."""
    total = 0.0
    for s in range(g0.shape[0]):
        th = np.float64(a[s])
        v = (
            g0[s, i] * (1 - th) * (1 - th)
            + g1[s, i] * 2 * th * (1 - th)
            + (1 - g0[s, i] - g1[s, i]) * th * th
        )
        total += math.log(v)
    return total


def _loo_serial_reference(g0, g1, labels, af_full, max_iter, tol):
    """Serial mirror of glassy.py:47-112 including the in-place AF mutation
    quirk: individual i's likelihood to pop j uses pop j's AF with the most
    recently processed pop-j member left out."""
    m, n = g0.shape
    pops = np.unique(labels)
    k = len(pops)
    af = np.array(af_full, dtype=np.float32)  # mutated in place, as in ref
    ll = np.zeros((n, k), dtype=np.float64)
    iters = np.zeros(n, dtype=np.int32)
    for i in range(n):
        members = np.flatnonzero(labels == labels[i])
        cols = [c for c in members if c != i]
        f, iters[i] = _em_scalar_members(g0, g1, cols, max_iter, tol)
        min_val = 1.0 / (2.0 * (len(cols) + 1))
        f = np.clip(f, min_val, 1.0 - min_val)
        pop_col = int(np.flatnonzero(pops == labels[i])[0])
        af[:, pop_col] = f
        for j in range(k):
            ll[i, j] = _loglike_scalar(g0, g1, af[:, j], i)
    return ll, iters


def test_loo_vs_serial_reference_loop():
    """Batched device LOO (incl. the order-dependent in-place-AF compat
    semantics) vs a from-scratch serial loop on a 3-pop case."""
    from wgsassign_jax.models.loo import leave_one_out

    m, n = 17, 9
    g0, g1 = _synth(m, n, seed=5)
    labels = np.array(["a"] * 3 + ["b"] * 3 + ["c"] * 3)
    popmap = population_map([f"Ind{i}" for i in range(n)], labels)

    # full-data clamped AF panel, serial reference semantics
    pops = np.unique(labels)
    af_full = np.empty((m, len(pops)), dtype=np.float32)
    for j, pop in enumerate(pops):
        cols = list(np.flatnonzero(labels == pop))
        f, _ = _em_scalar_members(g0, g1, cols, 200, 1e-4)
        min_val = 1.0 / (2.0 * (len(cols) + 1))
        af_full[:, j] = np.clip(f, min_val, 1.0 - min_val)

    beagle = BeagleData(
        np.stack([g0, g1], axis=2),
        [f"Ind{i}" for i in range(n)],
        [f"s{s}" for s in range(m)],
    )
    res = leave_one_out(beagle, af_full, popmap, compat_af_mutation=True)

    ll_ref, iters_ref = _loo_serial_reference(g0, g1, labels, af_full, 200, 1e-4)
    np.testing.assert_allclose(res.ll, ll_ref, rtol=2e-4, atol=2e-4)
    # accumulation order differs (device reductions vs serial f32) — allow
    # one iteration of convergence slack per problem
    assert np.max(np.abs(res.iters.astype(int) - iters_ref)) <= 1


def test_loo_column_index_hand_enumerated():
    """The in-place-AF order dependence, enumerated by hand on 2 pops:
    processing order 0,1,2 (pop a), 3,4 (pop b).  When individual i is
    evaluated against pop j, the AF bank row must be the *last-processed*
    pop-j member's LOO column, or the full-data column if none yet."""
    from wgsassign_jax.models.loo import loo_af_column_index

    labels = np.array(["a", "a", "a", "b", "b"])
    popmap = population_map([f"I{i}" for i in range(5)], labels)
    idx = loo_af_column_index(popmap, compat_af_mutation=True)
    n = 5
    expected = np.array([
        # pop a col          pop b col (full-data = n+1 until ind 3 ran)
        [0, n + 1],   # i=0: own LOO; no b member processed yet
        [1, n + 1],
        [2, n + 1],
        [2, 3],       # i=3: last a member processed is 2; own LOO for b
        [2, 4],
    ])
    np.testing.assert_array_equal(idx, expected)
    # clean mode: foreign pops always see the full-data AF
    idx_clean = loo_af_column_index(popmap, compat_af_mutation=False)
    expected_clean = np.array(
        [[0, n + 1], [1, n + 1], [2, n + 1], [n + 0, 3], [n + 0, 4]]
    )
    np.testing.assert_array_equal(idx_clean, expected_clean)


# ---------------------------------------------------------------------------
# Fisher information / Ne vs fisher_cy.pyx scalar loops
# ---------------------------------------------------------------------------

def _fisher_scalar(g0, g1, af, labels, pops):
    """fisher_cy.fisher_obs / ne_obs (fisher_cy.pyx:12-39): float32 scalar
    accumulation over pop members per site."""
    m = g0.shape[0]
    k = len(pops)
    f_obs = np.zeros((m, k), dtype=np.float32)
    for j, pop in enumerate(pops):
        cols = np.flatnonzero(labels == pop)
        for s in range(m):
            term_sum = np.float32(0.0)
            th = np.float32(af[s, j])
            for i in cols:
                gg0 = np.float32(g0[s, i])
                gg1 = np.float32(g1[s, i])
                gg2 = np.float32(1.0) - gg0 - gg1
                u = gg0 * (1 - th) * (1 - th) + gg1 * 2 * th * (1 - th) + gg2 * th * th
                n1 = np.float32(2.0) * (gg0 + gg2 - 2 * gg1)
                n2 = th * n1 + np.float32(2.0) * (gg1 - gg0)
                term = np.float32(-1.0) * (n1 / u - (n2 / u) * (n2 / u))
                term_sum = np.float32(term_sum + term)
            f_obs[s, j] = term_sum
    ne_obs = 0.5 * f_obs * af * (1.0 - af)
    return f_obs, ne_obs.astype(np.float32)


def _fisher_ind_scalar(g0, g1, af, labels, pops):
    """fisher_cy.fisher_obs_ind / ne_obs_ind + the mean at fisher.py:58."""
    m, n = g0.shape
    ne_ind = np.zeros(n, dtype=np.float64)
    for i in range(n):
        j = int(np.flatnonzero(pops == labels[i])[0])
        total = 0.0
        for s in range(m):
            th = np.float64(af[s, j])
            gg0, gg1 = np.float64(g0[s, i]), np.float64(g1[s, i])
            gg2 = 1.0 - gg0 - gg1
            u = gg0 * (1 - th) ** 2 + gg1 * 2 * th * (1 - th) + gg2 * th * th
            n1 = 2.0 * (gg0 + gg2 - 2 * gg1)
            n2 = th * n1 + 2.0 * (gg1 - gg0)
            term = -(n1 / u - (n2 / u) ** 2)
            total += 0.5 * term * th * (1 - th)
        ne_ind[i] = total / m
    return ne_ind


def test_fisher_vs_serial_reference_loop():
    import jax.numpy as jnp

    from wgsassign_jax.ops.fisher import fisher_obs_pops

    m, n = 23, 7
    g0, g1 = _synth(m, n, seed=9)
    labels = np.array(["a"] * 4 + ["b"] * 3)
    pops = np.unique(labels)
    popmap = population_map([f"I{i}" for i in range(n)], labels)
    rng = np.random.default_rng(1)
    af = rng.uniform(0.1, 0.9, size=(m, 2)).astype(np.float32)

    f_obs, ne_obs, ne_ind = fisher_obs_pops(
        jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(af),
        jnp.asarray(popmap.membership), jnp.asarray(popmap.pop_index),
        jnp.ones(m, jnp.float32), m,
    )
    f_ref, ne_ref = _fisher_scalar(g0, g1, af, labels, pops)
    ne_ind_ref = _fisher_ind_scalar(g0, g1, af, labels, pops)
    np.testing.assert_allclose(np.asarray(f_obs), f_ref, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(np.asarray(ne_obs), ne_ref, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(np.asarray(ne_ind), ne_ind_ref, rtol=2e-4)


# ---------------------------------------------------------------------------
# Mixture EM vs the reference fixed point (mixture.py:10-39)
# ---------------------------------------------------------------------------

def _em_mix_scalar(ll, n_iter):
    """Reference em_mix inner loop for one harvest pop: raw exp, diag(pi)
    matmul, row-normalize, column means; always runs all iterations."""
    n_ind, k = ll.shape
    pi_mat = np.diag(np.full(k, 1.0)) / k
    pi_vec = None
    for _ in range(n_iter):
        l_pi = np.exp(ll) @ pi_mat
        l_pi = l_pi / l_pi.sum(axis=1, keepdims=True)
        pi_vec = l_pi.sum(axis=0) / n_ind
        pi_mat = np.diag(pi_vec)
    return pi_vec


def test_mixture_vs_reference_fixed_point():
    from wgsassign_jax.models.mixture import em_mixture

    rng = np.random.default_rng(13)
    # feasible (pre-scaled) log-likelihoods, the regime where the
    # reference's raw-exp formulation does not underflow
    ll = rng.uniform(-4.0, 0.0, size=(12, 3))
    labels = np.array(["h1"] * 5 + ["h2"] * 7)

    res = em_mixture(ll, labels, n_iter=200, stable=False)
    res_stable = em_mixture(ll, labels, n_iter=200, stable=True)
    for h, pop in enumerate(res.harvest_pops):
        rows = np.flatnonzero(labels == pop)
        pi_ref = _em_mix_scalar(ll[rows], 200)
        np.testing.assert_allclose(res.pi[h], pi_ref, rtol=1e-10)
        # the LSE-stable variant agrees on feasible inputs
        np.testing.assert_allclose(res_stable.pi[h], pi_ref, rtol=1e-8)
