"""The four batched EM families of ops/emmaf.py against the serial oracle
EM of tests/oracle.py, one problem at a time: convergence iteration counts
and allele frequencies, with convergence inside the first iterations, fixed
iteration counts, padded sites, unaligned site counts and the 8-device
sharded mesh.  Also the engine path, the compile-cache placement and the
runtime's site padding."""

import os

import jax
import numpy as np
import pytest

import oracle
from wgsassign_jax.ops.emmaf import (
    em_maf_loo_group,
    em_maf_loo_subset,
    em_maf_pops,
    em_maf_sites_batch,
)
from wgsassign_jax.parallel.mesh import make_runtime

ATOL = 2e-6  # float32 summation order: device reductions vs NumPy pairwise


def _gl(m, n, seed):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(m, n)).astype(np.float32)
    return raw[:, :, 0], raw[:, :, 1]


def _oracle_em(g0, g1, max_iter, tol):
    """Serial oracle EM over the given member columns and sites."""
    legacy = np.empty((g0.shape[0], 2 * g0.shape[1]), np.float32)
    legacy[:, 0::2], legacy[:, 1::2] = g0, g1
    return oracle.emmaf(legacy, max_iter, tol)


CASES = [
    (1e-4, 200),   # normal convergence
    (0.0, 12),     # fixed iteration count
    (1e-2, 200),   # convergence within a few iterations
]


# ---------------------------------------------------------------------------
# all-populations EM (reference AF)
# ---------------------------------------------------------------------------

def _pops_problem(m=96, n=24, k=3, seed=0):
    g0, g1 = _gl(m, n, seed)
    pop_index = (np.arange(n) % k).astype(np.int32)
    membership = np.zeros((n, k), dtype=np.float32)
    membership[np.arange(n), pop_index] = 1.0
    return g0, g1, membership, pop_index


def _check_pops(f, iters, g0, g1, pop_index, max_iter, tol, atol=ATOL):
    f = np.asarray(f)
    for k in range(f.shape[1]):
        cols = np.flatnonzero(pop_index == k)
        f_ref, it_ref = _oracle_em(g0[:, cols], g1[:, cols], max_iter, tol)
        assert int(np.asarray(iters)[k]) == it_ref
        np.testing.assert_allclose(f[: g0.shape[0], k], f_ref, rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("tol,max_iter", CASES)
def test_em_maf_pops_matches_oracle(tol, max_iter):
    g0, g1, membership, pop_index = _pops_problem()
    m = g0.shape[0]
    f, iters, conv = em_maf_pops(
        g0, g1, membership, pop_index, np.ones(m, np.float32), m, max_iter,
        tol,
    )
    _check_pops(f, iters, g0, g1, pop_index, max_iter, tol)
    assert np.asarray(conv).all() == (tol > 0)


def test_em_maf_pops_padding_is_inert():
    """Zero-weight padded sites carrying the (1, 0) GL pattern change
    neither the AF at real sites nor any convergence decision."""
    g0, g1, membership, pop_index = _pops_problem(m=64)
    pad = 32
    g0p = np.concatenate([g0, np.ones((pad, g0.shape[1]), np.float32)])
    g1p = np.concatenate([g1, np.zeros((pad, g1.shape[1]), np.float32)])
    sw = np.concatenate([np.ones(64, np.float32), np.zeros(pad, np.float32)])
    f, iters, _ = em_maf_pops(g0p, g1p, membership, pop_index, sw, 64, 200,
                              1e-4)
    _check_pops(f, iters, g0, g1, pop_index, 200, 1e-4)


@pytest.mark.parametrize("m", [4000, 449])
def test_em_maf_pops_unaligned_site_count(m):
    g0, g1, membership, pop_index = _pops_problem(m=m, seed=7)
    f, iters, _ = em_maf_pops(g0, g1, membership, pop_index,
                              np.ones(m, np.float32), m, 50, 1e-4)
    # 50 unconverged iterations accumulate summation-order drift at a few
    # sites (1e-5 seen); half the EM's own 1e-4 tolerance bounds it
    _check_pops(f, iters, g0, g1, pop_index, 50, 1e-4, atol=5e-5)


def test_em_maf_pops_sharded_matches_oracle():
    rt = make_runtime(jax.devices())
    assert rt.n_devices == 8
    g0, g1, membership, pop_index = _pops_problem(m=128, n=16, k=2, seed=5)
    f, iters, _ = em_maf_pops(
        rt.shard_sites(g0), rt.shard_sites(g1), rt.replicate(membership),
        rt.replicate(pop_index), rt.shard_sites(np.ones(128, np.float32)),
        128, 100, 1e-4,
    )
    _check_pops(f, iters, g0, g1, pop_index, 100, 1e-4)


# ---------------------------------------------------------------------------
# leave-one-out EM of one population
# ---------------------------------------------------------------------------

def _loo_problem(m=96, n_p=7, seed=11):
    g0, g1 = _gl(m, n_p, seed)
    return np.ascontiguousarray(g0.T), np.ascontiguousarray(g1.T)


def _check_loo(f, iters, g0p, g1p, max_iter, tol):
    f = np.asarray(f)
    m = g0p.shape[1]
    for j in range(g0p.shape[0]):
        keep = np.arange(g0p.shape[0]) != j
        f_ref, it_ref = _oracle_em(g0p[keep].T, g1p[keep].T, max_iter, tol)
        assert int(np.asarray(iters)[j]) == it_ref
        np.testing.assert_allclose(f[j, :m], f_ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("tol,max_iter", CASES)
def test_em_maf_loo_group_matches_oracle(tol, max_iter):
    g0p, g1p = _loo_problem()
    m = g0p.shape[1]
    f, iters, _ = em_maf_loo_group(g0p, g1p, np.ones(m, np.float32), m,
                                   max_iter, tol)
    _check_loo(f, iters, g0p, g1p, max_iter, tol)


@pytest.mark.parametrize("n_p,m", [
    (2, 128),    # smallest LOO-able population: each problem keeps one member
    (72, 256),   # a large population
])
def test_em_maf_loo_group_population_sizes(n_p, m):
    g0p, g1p = _loo_problem(m=m, n_p=n_p, seed=21 + n_p)
    f, iters, _ = em_maf_loo_group(g0p, g1p, np.ones(m, np.float32), m, 60,
                                   1e-4)
    _check_loo(f, iters, g0p, g1p, 60, 1e-4)


def test_em_maf_loo_group_padding_is_inert():
    g0p, g1p = _loo_problem(m=64, n_p=5, seed=12)
    pad = 32
    g0pp = np.concatenate([g0p, np.ones((5, pad), np.float32)], axis=1)
    g1pp = np.concatenate([g1p, np.zeros((5, pad), np.float32)], axis=1)
    sw = np.concatenate([np.ones(64, np.float32), np.zeros(pad, np.float32)])
    f, iters, _ = em_maf_loo_group(g0pp, g1pp, sw, 64, 200, 1e-4)
    _check_loo(f, iters, g0p, g1p, 200, 1e-4)


def test_em_maf_loo_group_sharded_matches_oracle():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from wgsassign_jax.parallel.mesh import SNP_AXIS

    rt = make_runtime(jax.devices())
    g0p, g1p = _loo_problem(m=128, n_p=6, seed=13)
    shard = NamedSharding(rt.mesh, P(None, SNP_AXIS))
    f, iters, _ = em_maf_loo_group(
        jax.device_put(g0p, shard), jax.device_put(g1p, shard),
        rt.shard_sites(np.ones(128, np.float32)), 128, 100, 1e-4,
    )
    _check_loo(f, iters, g0p, g1p, 100, 1e-4)


# ---------------------------------------------------------------------------
# z-score reference mode: per-problem site subsets
# ---------------------------------------------------------------------------

def _sites_problem(b=5, p=9, s=64, seed=31):
    rng = np.random.default_rng(seed)
    raw = rng.dirichlet(np.ones(3), size=(b, p, s)).astype(np.float32)
    g0p, g1p = raw[:, :, :, 0], raw[:, :, :, 1]
    mem_mask = (rng.random((b, p)) < 0.8).astype(np.float32)
    mem_mask[:, 0] = 1.0  # at least one member per problem
    sw = np.zeros((b, s), np.float32)
    s_real = np.zeros(b, np.float32)
    for i in range(b):
        keep = int(rng.integers(s // 2, s + 1))
        sw[i, :keep] = 1.0
        s_real[i] = keep
    return g0p, g1p, mem_mask, sw, s_real


@pytest.mark.parametrize("tol,max_iter", CASES[:2])
def test_em_maf_sites_batch_matches_oracle(tol, max_iter):
    g0p, g1p, mem_mask, sw, s_real = _sites_problem()
    f, iters, _ = em_maf_sites_batch(g0p, g1p, mem_mask, sw, s_real,
                                     max_iter, tol)
    f = np.asarray(f)
    for b in range(g0p.shape[0]):
        mem = mem_mask[b] > 0
        s = int(s_real[b])
        f_ref, it_ref = _oracle_em(g0p[b, mem, :s].T, g1p[b, mem, :s].T,
                                   max_iter, tol)
        assert int(np.asarray(iters)[b]) == it_ref
        np.testing.assert_allclose(f[b, :s], f_ref, rtol=0, atol=ATOL)


def _subset_problem(m=256, n_p=10, b=4, seed=71):
    g0p, g1p = _loo_problem(m=m, n_p=n_p, seed=seed)
    rng = np.random.default_rng(seed + 1)
    leave = rng.choice(n_p, size=b, replace=False).astype(np.int32)
    sw = (rng.random((b, m)) < 0.7).astype(np.float32)
    sw[:, :8] = 1.0  # every problem keeps some sites
    return g0p, g1p, leave, sw, sw.sum(axis=1).astype(np.float32)


def _check_subset(f, iters, g0p, g1p, leave, sw, max_iter, tol):
    f = np.asarray(f)
    for b, j in enumerate(leave):
        keep = np.arange(g0p.shape[0]) != j
        ks = np.flatnonzero(sw[b])
        f_ref, it_ref = _oracle_em(g0p[keep][:, ks].T, g1p[keep][:, ks].T,
                                   max_iter, tol)
        assert int(np.asarray(iters)[b]) == it_ref
        np.testing.assert_allclose(f[b, ks], f_ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("tol,max_iter", CASES[:2])
def test_em_maf_loo_subset_matches_oracle(tol, max_iter):
    g0p, g1p, leave, sw, m_real = _subset_problem()
    f, iters, _ = em_maf_loo_subset(g0p, g1p, leave, sw, m_real, max_iter,
                                    tol)
    _check_subset(f, iters, g0p, g1p, leave, sw, max_iter, tol)


def test_em_maf_loo_subset_sharded_matches_oracle():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from wgsassign_jax.parallel.mesh import SNP_AXIS

    rt = make_runtime(jax.devices())
    g0p, g1p, leave, sw, m_real = _subset_problem(m=16 * rt.n_devices * 8)
    rows = NamedSharding(rt.mesh, P(None, SNP_AXIS))
    f, iters, _ = em_maf_loo_subset(
        jax.device_put(g0p, rows), jax.device_put(g1p, rows),
        rt.replicate(leave), jax.device_put(sw, rows), rt.replicate(m_real),
        150, 1e-4,
    )
    _check_subset(f, iters, g0p, g1p, leave, sw, 150, 1e-4)


def test_loo_subset_matches_sites_batch():
    """The full-axis LOO-subset EM reproduces em_maf_sites_batch's
    kept-site results (per-site independence): same values at kept sites,
    same convergence iteration counts."""
    g0p, g1p, leave, sw, m_real = _subset_problem()
    n_p = g0p.shape[0]
    b = leave.shape[0]
    f_sub, it_sub, conv_sub = em_maf_loo_subset(
        g0p, g1p, leave, sw, m_real, 200, 1e-4
    )
    s_max = int(m_real.max())
    wk = np.zeros((b, s_max), np.float32)
    g0g = np.ones((b, n_p, s_max), np.float32)
    g1g = np.zeros((b, n_p, s_max), np.float32)
    mem_mask = np.ones((b, n_p), np.float32)
    for i in range(b):
        ks = np.flatnonzero(sw[i])
        wk[i, : ks.size] = 1.0
        g0g[i, :, : ks.size] = g0p[:, ks]
        g1g[i, :, : ks.size] = g1p[:, ks]
        mem_mask[i, leave[i]] = 0.0
    f_g, it_g, conv_g = em_maf_sites_batch(
        g0g, g1g, mem_mask, wk, m_real, 200, 1e-4
    )
    np.testing.assert_array_equal(np.asarray(it_sub), np.asarray(it_g))
    np.testing.assert_array_equal(np.asarray(conv_sub), np.asarray(conv_g))
    for i in range(b):
        ks = np.flatnonzero(sw[i])
        np.testing.assert_allclose(
            np.asarray(f_sub)[i, ks], np.asarray(f_g)[i, : ks.size],
            rtol=0, atol=ATOL,
        )


# ---------------------------------------------------------------------------
# engine path, padding and compile cache
# ---------------------------------------------------------------------------

def test_engine_path_follows_platform():
    rt = make_runtime(jax.devices()[:1])
    assert rt.engine == f"xla on 1 x {jax.devices()[0].device_kind} (cpu)"
    assert make_runtime(jax.devices()).engine.startswith("xla on 8 x ")


@pytest.mark.gpu
def test_engine_path_on_gpu(gpu_device):
    rt = make_runtime([gpu_device])
    assert rt.engine.startswith("xla on 1 x ") and rt.engine.endswith("(gpu)")
    g0, g1, membership, pop_index = _pops_problem(m=512, n=24, k=3)
    with jax.default_matmul_precision("highest"):
        f, iters, _ = em_maf_pops(
            rt.shard_sites(g0), rt.shard_sites(g1), rt.replicate(membership),
            rt.replicate(pop_index), rt.shard_sites(np.ones(512, np.float32)),
            512, 200, 1e-4,
        )
    _check_pops(f, iters, g0, g1, pop_index, 200, 1e-4)


def test_site_multiple_is_mesh_times_extra():
    rt = make_runtime(jax.devices())
    assert rt.site_multiple() == 8
    assert rt.site_multiple(3) == 24


@pytest.mark.parametrize("env_dir", [True, False])
def test_compilation_cache_placement(env_dir, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache goes to .jax_cache/ at the root of the checkout."""
    from wgsassign_jax.parallel import mesh

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert mesh.enable_compilation_cache() == str(tmp_path)
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        want = os.path.join(root, ".jax_cache")
        assert mesh.enable_compilation_cache() == want
        assert calls == [("jax_compilation_cache_dir", want)]
