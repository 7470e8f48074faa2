"""float64 site-axis accumulation (reference glassy.py:38,101 compat).

Quantifies the f32-vs-f64 deviation at a production-like site count and
pins the blocked-f32→f64 scheme against a true NumPy float64 reduction.
"""

import numpy as np
import jax.numpy as jnp

from wgsassign_jax.ops.loglik import (
    _pick_block,
    assign_loglik,
    assign_loglik_f64,
    assign_loglik_partitioned_f64,
    assign_loglik_selected_f64,
    site_loglik,
)


def _problem(m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)
    af = rng.uniform(0.05, 0.95, size=(m, k)).astype(np.float32)
    return raw[:, :, 0], raw[:, :, 1], af


def test_pick_block_divides():
    for m in (100, 449, 456, 4096, 4097, 1 << 20, 999_424):
        b = _pick_block(m)
        assert m % b == 0
        assert b <= max(m, 4096)


def test_blocked_f64_matches_numpy_f64():
    # 2^17 sites: large enough that f32 vs f64 visibly diverge
    m, n, k = 1 << 17, 8, 3
    g0, g1, af = _problem(m, n, k)
    w = np.ones(m, np.float32)

    # exact reference semantics: per-site f32 values, f64 accumulator
    per_site = np.asarray(
        site_loglik(jnp.asarray(g0)[:, :, None], jnp.asarray(g1)[:, :, None],
                    jnp.asarray(af)[:, None, :])
    )
    expect = per_site.astype(np.float64).sum(axis=0)

    got = assign_loglik_f64(
        jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(af), jnp.asarray(w)
    )
    assert got.dtype == np.float64
    # blocked f32 partials differ from a serial f64 accumulator only by the
    # in-block f32 rounding: tight absolute bound on an O(1e5)-magnitude sum
    np.testing.assert_allclose(got, expect, atol=5e-3, rtol=0)

    # quantify that the pure-f32 path is strictly worse (documents why the
    # f64 scheme is the default)
    f32 = np.asarray(
        assign_loglik(jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(af),
                      jnp.asarray(w))
    )
    err_f32 = np.abs(f32 - expect).max()
    err_blocked = np.abs(got - expect).max()
    assert err_blocked <= err_f32 + 1e-9


def test_partitioned_f64_consistent():
    m, n, k, p = 4096, 6, 2, 4
    g0, g1, af = _problem(m, n, k, seed=1)
    w = np.ones(m, np.float32)
    parts = assign_loglik_partitioned_f64(
        jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(af), jnp.asarray(w), p
    )
    total = assign_loglik_f64(
        jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(af), jnp.asarray(w)
    )
    # the partitioned path blocks strided site groups, so its in-block f32
    # rounding differs from the contiguous path by O(block * eps)
    np.testing.assert_allclose(parts.sum(axis=0), total, rtol=0, atol=1e-2)


def test_selected_f64_matches_dense():
    m, n, k = 2048, 5, 3
    g0, g1, af = _problem(m, n, k, seed=2)
    w = np.ones(m, np.float32)
    # bank = the K full-data AF columns; col_idx selects column k for all i
    bank_t = jnp.asarray(af.T)
    col_idx = jnp.asarray(np.tile(np.arange(k, dtype=np.int32), (n, 1)))
    got = assign_loglik_selected_f64(
        jnp.asarray(g0), jnp.asarray(g1), bank_t, col_idx, jnp.asarray(w)
    )
    expect = assign_loglik_f64(
        jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(af), jnp.asarray(w)
    )
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-6)
