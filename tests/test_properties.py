"""Independent brute-force property tests.

The golden fixtures come from tests/oracle.py, which is itself a vectorized
NumPy implementation — these tests cross-check the device kernels against
*serial scalar loops* that mirror the reference's Cython kernels line by
line (emMAF_cy.pyx:10-33, zscore_cy.pyx:10-56), so a shared vectorization
mistake in the oracle cannot hide a kernel bug.  Plus a random-GL Beagle
write/parse fuzz roundtrip for the loaders.
"""

import gzip
import math

import numpy as np
import pytest


# ---------------------------------------------------------------------------
# z-score sums: kernel vs serial split enumeration (zscore_cy.pyx semantics)
# ---------------------------------------------------------------------------

def _zscore_bruteforce(g0k, g1k, a, depths, combos, mean_gl, read_probs):
    """Serial per-site, per-split enumeration in float64 — the reference's
    expected_W_l / variance_W_l loops (zscore_cy.pyx:10-56) with consistent
    table indexing."""
    row_of = {(int(ar), int(aa)): r for r, (ar, aa) in enumerate(combos)}
    w_obs = w_mu = w_var = 0.0
    for s in range(len(g0k)):
        p0 = (1.0 - a[s]) ** 2
        p1 = 2.0 * a[s] * (1.0 - a[s])
        p2 = a[s] ** 2
        g2 = 1.0 - g0k[s] - g1k[s]
        w_obs += math.log(g0k[s] * p0 + g1k[s] * p1 + g2 * p2)
        d = int(depths[s])
        mu_s = 0.0
        lgs, wts = [], []
        for aa in range(d + 1):
            r = row_of[(d - aa, aa)]
            lg = math.log(
                mean_gl[r, 0] * p0 + mean_gl[r, 1] * p1 + mean_gl[r, 2] * p2
            )
            wt = (
                read_probs[r, 0] * p0
                + read_probs[r, 1] * p1
                + read_probs[r, 2] * p2
            )
            mu_s += lg * wt
            lgs.append(lg)
            wts.append(wt)
        w_mu += mu_s
        w_var += sum((mu_s - lg) ** 2 * wt for lg, wt in zip(lgs, wts))
    return w_obs, w_mu, w_var


def test_zscore_sums_vs_bruteforce():
    import jax.numpy as jnp

    from wgsassign_jax.ops.zscore_ops import zscore_sums

    rng = np.random.default_rng(7)
    max_d = 3
    combos = [(d - aa, aa) for d in range(1, max_d + 1) for aa in range(d + 1)]
    r_n = len(combos)
    mean_gl = rng.dirichlet(np.ones(3), size=r_n).astype(np.float32)
    read_probs = rng.uniform(0.05, 1.0, size=(r_n, 3)).astype(np.float32)

    s_n = 48
    depths = rng.integers(1, max_d + 1, size=s_n)
    gl = rng.dirichlet(np.ones(3), size=s_n).astype(np.float32)
    g0k, g1k = gl[:, 0], gl[:, 1]
    a = rng.uniform(0.05, 0.95, size=s_n).astype(np.float32)

    row_of = {c: r for r, c in enumerate(combos)}
    c_max = max_d + 1
    split_rows = np.zeros((s_n, c_max), dtype=np.int32)
    split_mask = np.zeros((s_n, c_max), dtype=np.float32)
    for s in range(s_n):
        for aa in range(int(depths[s]) + 1):
            split_rows[s, aa] = row_of[(int(depths[s]) - aa, aa)]
            split_mask[s, aa] = 1.0

    w_obs, w_mu, w_var = zscore_sums(
        jnp.asarray(g0k), jnp.asarray(g1k), jnp.asarray(a),
        jnp.ones(s_n, jnp.float32), jnp.asarray(split_rows),
        jnp.asarray(split_mask), jnp.asarray(mean_gl), jnp.asarray(read_probs),
    )
    e_obs, e_mu, e_var = _zscore_bruteforce(
        g0k.astype(np.float64), g1k.astype(np.float64), a.astype(np.float64),
        depths, combos, mean_gl.astype(np.float64),
        read_probs.astype(np.float64),
    )
    np.testing.assert_allclose(float(w_obs), e_obs, rtol=1e-4)
    np.testing.assert_allclose(float(w_mu), e_mu, rtol=1e-4)
    np.testing.assert_allclose(float(w_var), e_var, rtol=1e-3)


# ---------------------------------------------------------------------------
# MAF EM: batched op vs serial scalar loop (emMAF_cy.pyx semantics)
# ---------------------------------------------------------------------------

def _em_scalar(g0, g1, max_iter, tol):
    """Serial per-site, per-individual EM exactly as emMAF_cy.pyx:10-33
    (float32 state, float64 inner accumulators are NOT used there — the
    Cython kernel accumulates in float32 `tmp`; we mirror that)."""
    m, n = g0.shape
    f = np.full(m, 0.25, dtype=np.float32)
    for it in range(max_iter):
        f_new = np.empty_like(f)
        for s in range(m):
            tmp = np.float32(0.0)
            for i in range(n):
                fs = f[s]
                p0 = np.float32(g0[s, i] * (1 - fs) * (1 - fs))
                p1 = np.float32(g1[s, i] * 2 * fs * (1 - fs))
                p2 = np.float32((1 - g0[s, i] - g1[s, i]) * fs * fs)
                tmp += np.float32((p1 + 2 * p2) / (2 * (p0 + p1 + p2)))
            f_new[s] = tmp / np.float32(n)
        d = f_new.astype(np.float64) - f.astype(np.float64)
        rmse = math.sqrt(np.mean(d * d))
        f = f_new
        if rmse < tol:
            return f, it + 1
    return f, max_iter


def test_em_maf_pops_vs_scalar_loop():
    import jax.numpy as jnp

    from wgsassign_jax.ops.emmaf import em_maf_pops

    rng = np.random.default_rng(3)
    m, n = 17, 6
    gl = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)
    g0, g1 = gl[:, :, 0], gl[:, :, 1]
    f_ref, iters_ref = _em_scalar(g0, g1, max_iter=200, tol=1e-4)

    membership = np.ones((n, 1), dtype=np.float32)
    pop_index = np.zeros(n, dtype=np.int32)
    f, iters, conv = em_maf_pops(
        jnp.asarray(g0), jnp.asarray(g1), jnp.asarray(membership),
        jnp.asarray(pop_index), jnp.ones(m, jnp.float32), m, 200, 1e-4,
    )
    assert bool(conv[0])
    # accumulation order differs (serial scalar vs dot) — tolerance-level
    np.testing.assert_allclose(np.asarray(f)[:, 0], f_ref, rtol=5e-5, atol=5e-6)
    # accumulation-order differences (MXU dot vs serial sum) can flip an
    # RMSE-vs-tol decision exactly at the boundary on some backends; allow
    # one iteration of slack
    assert abs(int(iters[0]) - iters_ref) <= 1


# ---------------------------------------------------------------------------
# loader fuzz: random GLs -> Beagle gz -> both parsers
# ---------------------------------------------------------------------------

def test_beagle_fuzz_roundtrip(tmp_path):
    from wgsassign_jax._native import read_beagle_native
    from wgsassign_jax.io.beagle import _read_beagle_python
    from wgsassign_jax.io.synth import write_beagle

    rng = np.random.default_rng(11)
    for trial, (m, n) in enumerate([(1, 1), (7, 3), (64, 17)]):
        gl = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)[:, :, :2]
        p = tmp_path / f"fuzz{trial}.beagle.gz"
        write_beagle(str(p), gl)
        py = _read_beagle_python(str(p))
        assert py.gl.shape == (m, n, 2)
        # values survive the %.6f text roundtrip
        np.testing.assert_allclose(py.gl, gl, atol=1.1e-6)
        native = read_beagle_native(str(p))
        if native is not None:
            np.testing.assert_array_equal(native.gl, py.gl)
            assert native.sample_names == py.sample_names
            assert native.site_names == py.site_names


def test_beagle_non_normalized_triples(tmp_path):
    """GL triples that do not sum to 1 are preserved as-is: the reader keeps
    (g0, g1) verbatim (reference reader_cy.pyx:62-66 drops the 3rd column
    without checking normalization)."""
    from wgsassign_jax.io.beagle import _read_beagle_python

    p = tmp_path / "unnorm.beagle.gz"
    with gzip.open(p, "wt") as f:
        f.write("marker\tallele1\tallele2\tInd0\tInd0\tInd0\n")
        f.write("s1\t0\t1\t0.9\t0.8\t0.7\n")
    d = _read_beagle_python(str(p))
    np.testing.assert_allclose(d.gl[0, 0], [0.9, 0.8], rtol=1e-6)


def test_beagle_fuzz_range_and_stream(tmp_path):
    """Fuzz the windowed and streamed readers: random row windows of both
    parsers and the native block stream must reproduce slices of the full
    parse; the site-name scan must match the parsed names."""
    from wgsassign_jax._native import open_beagle_stream, read_beagle_native
    from wgsassign_jax.io.beagle import (
        _read_beagle_python,
        read_beagle,
        scan_site_names,
    )
    from wgsassign_jax.io.stream import open_block_iterator
    from wgsassign_jax.io.synth import write_beagle

    rng = np.random.default_rng(23)
    for trial, (m, n) in enumerate([(5, 2), (41, 7), (128, 3)]):
        gl = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)[:, :, :2]
        p = tmp_path / f"rfuzz{trial}.beagle.gz"
        write_beagle(str(p), gl)
        full = read_beagle(str(p))
        assert scan_site_names(str(p)) == full.site_names

        for _ in range(4):
            lo = int(rng.integers(0, m + 1))
            hi = int(rng.integers(lo, m + 1))
            win_py = _read_beagle_python(str(p), row_range=(lo, hi))
            np.testing.assert_array_equal(win_py.gl, full.gl[lo:hi])
            assert win_py.site_names == full.site_names[lo:hi]
            win_nat = read_beagle_native(str(p), row_range=(lo, hi))
            if win_nat is not None:
                np.testing.assert_array_equal(win_nat.gl, full.gl[lo:hi])
                assert win_nat.site_names == full.site_names[lo:hi]

        block_rows = int(rng.integers(1, m + 2))
        meta, blocks = open_block_iterator(str(p), block_rows)
        assert (meta.n_sites, meta.n_inds) == (m, n)
        got, names = [], []
        for gl_block, sites in blocks:
            assert gl_block.shape[0] <= block_rows
            got.append(gl_block)
            names.extend(sites)
        np.testing.assert_array_equal(np.concatenate(got), full.gl)
        assert names == full.site_names


def test_beagle_stream_malformed_mid_file(tmp_path):
    """A ragged row deep in the file must surface as a parse error from the
    native stream (not silently truncate the cohort)."""
    import pytest

    from wgsassign_jax._native import open_beagle_stream

    p = tmp_path / "ragged.beagle.gz"
    with gzip.open(p, "wt") as f:
        f.write("marker\tallele1\tallele2\tInd0\tInd0\tInd0\n")
        for i in range(10):
            f.write(f"s{i}\t0\t1\t0.2\t0.3\t0.5\n")
        f.write("sbad\t0\t1\t0.2\t0.3\n")  # missing a GL column
    stream = open_beagle_stream(str(p))
    if stream is None:
        pytest.skip("native loader unavailable")
    with stream:
        with pytest.raises(ValueError, match="Malformed"):
            while stream.next_block(4) is not None:
                pass
