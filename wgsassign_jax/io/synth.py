"""Synthetic cohort generation at production scale.

Generates multi-million-SNP genotype-likelihood cohorts (BASELINE.json's
N-host benchmark configs) either as in-memory arrays or as a gzipped Beagle
file for end-to-end pipeline benchmarking.  The model matches the bundled
amre data's generative process: per (site, individual), true genotypes from
HWE at a per-population AF (populations get Balding-Nichols-style divergence
around an ancestral AF), reads at Poisson depth with error rate e, and GLs
proportional to the binomial read likelihoods.
"""

from __future__ import annotations

import gzip

import numpy as np


def _gl_table(max_depth: int, e: float) -> np.ndarray:
    """Normalized (GL0, GL1) for every (major, minor) read-count pair —
    the likelihood depends only on the counts, so per-element transcendental
    ops become one table gather."""
    maj, mino = np.meshgrid(
        np.arange(max_depth + 1), np.arange(max_depth + 1), indexing="ij"
    )
    l0 = (1 - e) ** maj * e**mino
    l1 = 0.5 ** (maj + mino).astype(np.float64)
    l2 = e**maj * (1 - e) ** mino
    tot = l0 + l1 + l2
    table = np.empty((max_depth + 1, max_depth + 1, 2), dtype=np.float32)
    table[:, :, 0] = l0 / tot
    table[:, :, 1] = l1 / tot
    return table


def population_afs(m_sites: int, n_pops: int, fst: float, rng) -> np.ndarray:
    """``[M, K]`` per-population allele frequencies: Balding-Nichols draws
    around a uniform ancestral frequency."""
    anc = rng.uniform(0.05, 0.95, size=m_sites)
    a = anc * (1.0 - fst) / fst
    b = (1.0 - anc) * (1.0 - fst) / fst
    return rng.beta(a[:, None], b[:, None], size=(m_sites, n_pops))


def sample_reads(pop_af: np.ndarray, pop_of: np.ndarray, rng,
                 mean_depth: float = 2.0, error_rate: float = 0.01):
    """Genotypes under HWE at each individual's population frequency
    (``pop_af [M, K]``, ``pop_of [N]``), reads at Poisson depth, and the
    GLs of those reads.  Returns ``(gl [M, N, 2] float32, ad [M, 2N]
    int32)`` with AD columns (major, minor) per individual."""
    geno = rng.binomial(2, pop_af[:, pop_of])  # [M, N]
    depth = rng.poisson(mean_depth, size=geno.shape)
    p_minor_of_geno = np.array(
        [error_rate, 0.5, 1.0 - error_rate], dtype=np.float64
    )
    minor = rng.binomial(depth, p_minor_of_geno[geno])
    major = depth - minor
    dmax = int(depth.max()) if depth.size else 0
    table = _gl_table(max(dmax, 1), error_rate)
    ad = np.empty((geno.shape[0], 2 * geno.shape[1]), dtype=np.int32)
    ad[:, 0::2] = major
    ad[:, 1::2] = minor
    return table[major, minor], ad


def synth_cohort(
    m_sites: int,
    n_inds: int,
    n_pops: int = 5,
    mean_depth: float = 2.0,
    error_rate: float = 0.01,
    fst: float = 0.05,
    seed: int = 0,
):
    """Returns ``(gl [M, N, 2] float32, pop_labels [N], ad [M, 2N] int32)``.

    Chunked over sites (bounds peak host memory to ~chunk*N temporaries) with
    table-lookup likelihoods — multi-million-SNP cohorts generate in seconds
    per million sites instead of minutes.
    """
    rng = np.random.default_rng(seed)
    pop_of = np.arange(n_inds) % n_pops
    gl = np.empty((m_sites, n_inds, 2), dtype=np.float32)
    ad = np.empty((m_sites, 2 * n_inds), dtype=np.int32)
    chunk = max(1, min(m_sites, (1 << 26) // max(n_inds, 1)))
    for lo in range(0, m_sites, chunk):
        hi = min(lo + chunk, m_sites)
        pop_af = population_afs(hi - lo, n_pops, fst, rng)
        gl[lo:hi], ad[lo:hi] = sample_reads(
            pop_af, pop_of, rng, mean_depth, error_rate
        )
    labels = np.array([f"pop{p}" for p in pop_of])
    return gl, labels, ad


def write_beagle(path: str, gl: np.ndarray, compresslevel: int = 1,
                 sites=None) -> str:
    """Write ``[M, N, 2]`` GLs as a gzipped Beagle file.  Row ``r`` is named
    after site index ``sites[r]`` (default ``r``), so a subset of a file's
    rows keeps that file's site names."""
    m, n, _ = gl.shape
    if sites is None:
        sites = range(m)
    g2 = 1.0 - gl[:, :, 0] - gl[:, :, 1]
    with gzip.open(path, "wt", compresslevel=compresslevel) as f:
        f.write(
            "marker\tallele1\tallele2"
            + "".join(f"\tInd{i}\tInd{i}\tInd{i}" for i in range(n))
            + "\n"
        )
        for r, s in enumerate(sites):
            row = np.empty(3 * n, dtype=np.float32)
            row[0::3] = gl[r, :, 0]
            row[1::3] = gl[r, :, 1]
            row[2::3] = g2[r]
            f.write(
                f"scaffold{s % 1000}_{s}\t1\t2\t"
                + "\t".join(f"{v:.6f}" for v in row)
                + "\n"
            )
    return path


def synth_beagle_file(
    path: str,
    m_sites: int,
    n_inds: int,
    n_pops: int = 5,
    seed: int = 0,
    compresslevel: int = 1,
    chunk: int = 100_000,
) -> str:
    """Write a synthetic gzipped Beagle file of arbitrary size chunk by
    chunk — peak host memory O(chunk * N), so scale-benchmark inputs far
    larger than RAM-resident matrices can be produced.

    Formatting is fully vectorized: GLs are fixed-point "%.6f" values in
    [0, 1], rendered digit-by-digit into a fixed-width uint8 byte matrix
    (the pure-Python row loop in :func:`write_beagle` is fine for test
    fixtures but ~100x too slow at benchmark scale)."""
    import gzip as _gzip

    with _gzip.open(path, "wb", compresslevel=compresslevel) as f:
        f.write(
            (
                "marker\tallele1\tallele2"
                + "".join(f"\tInd{i}\tInd{i}\tInd{i}" for i in range(n_inds))
                + "\n"
            ).encode()
        )
        for lo in range(0, m_sites, chunk):
            hi = min(lo + chunk, m_sites)
            gl, _, _ = synth_cohort(
                hi - lo, n_inds, n_pops=n_pops, seed=seed + 1 + lo
            )
            body = np.empty((hi - lo, 3 * n_inds), dtype=np.float32)
            body[:, 0::3] = gl[:, :, 0]
            body[:, 1::3] = gl[:, :, 1]
            body[:, 2::3] = 1.0 - gl[:, :, 0] - gl[:, :, 1]
            f.write(_fixed6_rows(body, lo).tobytes())
    return path


def _fixed6_rows(body: np.ndarray, row0: int) -> np.ndarray:
    """Render ``[r, c]`` floats in [0, 1] as Beagle data rows:
    ``s<10-digit site id>\t1\t2\t`` + c tab-separated "%.6f" values +
    newline, as a uint8 matrix (one fixed-width row per site)."""
    r, c = body.shape
    v = np.round(np.clip(body, 0.0, 1.0).astype(np.float32) * 1e6)
    v = v.astype(np.int32)  # 0..1_000_000
    prefix_len = 1 + 10 + 5  # "s" + id + "\t1\t2\t"
    width = prefix_len + 9 * c  # 8 chars + separator per value
    out = np.empty((r, width), dtype=np.uint8)
    # site-id prefix
    ids = np.arange(row0, row0 + r, dtype=np.int64)
    out[:, 0] = ord("s")
    for d in range(10):
        out[:, 1 + d] = 48 + (ids // 10 ** (9 - d)) % 10
    out[:, 11:16] = np.frombuffer(b"\t1\t2\t", dtype=np.uint8)
    # values: integer part, '.', six fraction digits (two 3-digit lookup
    # gathers — per-digit divmod over the full matrix is ~10x slower),
    # separator
    val = out[:, prefix_len:].reshape(r, c, 9)
    val[..., 0] = 48 + (v // 1_000_000).astype(np.uint8)
    val[..., 1] = ord(".")
    frac = v % 1_000_000
    table3 = np.empty((1000, 3), dtype=np.uint8)
    k = np.arange(1000)
    table3[:, 0] = 48 + k // 100
    table3[:, 1] = 48 + (k // 10) % 10
    table3[:, 2] = 48 + k % 10
    val[..., 2:5] = table3[frac // 1000]
    val[..., 5:8] = table3[frac % 1000]
    val[..., 8] = ord("\t")
    out[:, -1] = ord("\n")
    return out


def synth_device_panels(m_sites: int, pop_sizes, mean_depth: float = 2.0,
                        error_rate: float = 0.01, fst: float = 0.05,
                        seed: int = 0, chunk: int = 1 << 20):
    """The :func:`synth_cohort` model sampled on the default device with
    ``jax.random``, for cohorts whose host-side generation would take
    minutes.  Individuals are grouped by population in ``pop_sizes`` order.

    Returns ``(g0, g1)`` float32 ``[M, N]`` device arrays and the
    ``[N]`` population index of each individual."""
    import jax
    import jax.numpy as jnp

    pop_of = np.repeat(np.arange(len(pop_sizes)), pop_sizes).astype(np.int32)
    max_depth = 31  # Poisson(mean_depth) draws are clipped here
    table = jnp.asarray(_gl_table(max_depth, error_rate))
    p_minor = jnp.asarray([error_rate, 0.5, 1.0 - error_rate], jnp.float32)
    pop_d = jnp.asarray(pop_of)

    @jax.jit
    def block(key):
        k_anc, k_af, k_geno, k_depth, k_reads = jax.random.split(key, 5)
        anc = jax.random.uniform(k_anc, (chunk,), minval=0.05, maxval=0.95)
        a = anc * (1.0 - fst) / fst
        b = (1.0 - anc) * (1.0 - fst) / fst
        af = jax.random.beta(
            k_af, a[:, None], b[:, None], (chunk, len(pop_sizes))
        )
        p = af[:, pop_d]
        geno = jax.random.binomial(k_geno, 2.0, p).astype(jnp.int32)
        depth = jnp.minimum(
            jax.random.poisson(k_depth, mean_depth, p.shape), max_depth
        )
        minor = jax.random.binomial(
            k_reads, depth.astype(jnp.float32), p_minor[geno]
        ).astype(jnp.int32)
        gl = table[depth - minor, minor]
        return gl[..., 0], gl[..., 1]

    chunk = min(chunk, m_sites)
    keys = jax.random.split(jax.random.key(seed), -(-m_sites // chunk))
    parts = [block(k) for k in keys]
    g0 = jnp.concatenate([p[0] for p in parts])[:m_sites]
    g1 = jnp.concatenate([p[1] for p in parts])[:m_sites]
    return g0, g1, pop_of
