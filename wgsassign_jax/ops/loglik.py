"""Assignment log-likelihood ops (reference glassy.py / glassy_cy.pyx).

Per (site, individual, population) the assignment likelihood under HWE is

    P(D_si | pop k) = g0*(1-a)^2 + g1*2a(1-a) + g2*a^2,   a = af[s, k]

and the assignment log-likelihood is the sum of logs over sites
(glassy_cy.pyx:12-21, summed at glassy.py:38).

Design: where the reference launches N*K separate M-length scans, we
compute the whole ``[N, K]`` matrix in one fused pass — the elementwise
``log(...)`` producer fuses into the site-axis reduction, so the ``[M, N, K]``
intermediate never materializes.  Padded sites are masked with a per-site
weight.  Partitioned variants reshape the (padded) site axis to ``[Q, P]``
so partition ``p`` collects sites with ``s % P == p``, matching reference
utils.partition_loglikes (utils.py:129-151).

float64 accumulation: the reference sums the per-site float32 log-liks with
a float64 accumulator (``np.sum(logl_vec, dtype=float)``, glassy.py:38,101).
A plain f32 site-axis reduction drifts at production scale — at 5M sites the
sum magnitude is ~5e6 where f32 spacing is 0.5, so even a tree reduction
carries O(10) absolute error.  The device kernels therefore emit **per-site-block f32 partial sums** (each block small
enough that its in-block tree reduction is eps-accurate) and the tiny
``[NB, N, K]`` partial tensor is combined in float64 on the host — the
"chunked f32→f64" scheme.  ``*_f64`` wrappers below do both steps.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from wgsassign_jax.parallel.mesh import fetch_to_host

_F32 = jnp.float32

# Target site-block length for the f32 partial sums.  Block sums have
# magnitude O(block), so their in-block f32 error is ~eps*log2(block)*block
# — negligible against the f64 combine.
_SUM_BLOCK = 4096


@functools.lru_cache(maxsize=None)
def _pick_block(m: int) -> int:
    """Largest divisor of ``m`` that is <= _SUM_BLOCK (1 if m is prime-ish;
    the degenerate 1-block case is just a f64 host sum of per-site values —
    only reachable for tiny unpadded site counts)."""
    if m <= _SUM_BLOCK:
        return m
    for b in range(_SUM_BLOCK, 63, -1):
        if m % b == 0:
            return b
    # pathological (near-prime) site count: degenerate to one block rather
    # than emitting a huge partial tensor; unreachable for padded cohorts
    return m


def site_loglik(g0, g1, a):
    """log( g0*(1-a)^2 + g1*2a(1-a) + (1-g0-g1)*a^2 ), broadcasting."""
    oma = 1.0 - a
    like = g0 * oma * oma + g1 * 2.0 * a * oma + (1.0 - g0 - g1) * a * a
    return jnp.log(like)


def check_loglik_inputs(g0, g1, af, site_weight):
    """Sanitizer for the reachable ``log(0)`` (SURVEY §5): malformed GL
    triples (negative GLs, or g0+g1 > 1 making g2 negative) drive the
    per-site likelihood to zero or below, which the fast path would fold
    into silent ``-inf``/NaN log-likelihood sums.  Run under
    ``--debug_checks`` before the assignment/LOO likelihood passes; raises
    ``jax.experimental.checkify.JaxRuntimeError`` with a cell count.

    The ``[M, N, K]`` predicate fuses into the count reduction, so nothing
    cubic materializes.
    """
    from jax.experimental import checkify

    @jax.jit
    def bad_cells(g0, g1, af, sw):
        a = af[:, None, :]
        oma = 1.0 - a
        like = (
            g0[:, :, None] * oma * oma
            + g1[:, :, None] * 2.0 * a * oma
            + (1.0 - g0 - g1)[:, :, None] * a * a
        )
        return jnp.sum(
            ((like <= 0.0) | jnp.isnan(like)) & (sw[:, None, None] > 0.0)
        )

    def checked(g0, g1, af, sw):
        n = bad_cells(g0, g1, af, sw)
        checkify.check(
            n == 0,
            "non-positive assignment likelihood at {n} (site, individual, "
            "population) cells — malformed GL triples (negative GLs or "
            "g0+g1 > 1)?",
            n=n,
        )
        return n

    err, _ = checkify.checkify(checked)(g0, g1, af, site_weight)
    err.throw()


@jax.jit
def assign_loglik(g0, g1, af, site_weight):
    """Full ``[N, K]`` assignment log-likelihood matrix (f32 reduction).

    Args:
      g0, g1: float32 ``[M, N]``.
      af: float32 ``[M, K]`` population allele frequencies.
      site_weight: float32 ``[M]`` (0 for padded sites).

    Returns: float32 ``[N, K]``.
    """
    ll = site_loglik(g0[:, :, None], g1[:, :, None], af[:, None, :])
    ll = ll * site_weight[:, None, None]
    return jnp.sum(ll, axis=0)


@functools.partial(jax.jit, static_argnames=("block",))
def _assign_loglik_blocked(g0, g1, af, site_weight, block: int):
    """Per-site-block partial sums ``[NB, N, K]`` (f32)."""
    m, n = g0.shape
    k = af.shape[1]
    ll = site_loglik(g0[:, :, None], g1[:, :, None], af[:, None, :])
    ll = ll * site_weight[:, None, None]
    return jnp.sum(ll.reshape(m // block, block, n, k), axis=1)


def assign_loglik_f64(g0, g1, af, site_weight) -> np.ndarray:
    """``[N, K]`` assignment log-likelihoods with the reference's float64
    site-axis accumulation (glassy.py:38): blocked f32 partials on device,
    f64 combine on host.  Returns np.float64."""
    block = _pick_block(g0.shape[0])
    parts = _assign_loglik_blocked(g0, g1, af, site_weight, block)
    return fetch_to_host(parts).astype(np.float64).sum(axis=0)


@functools.partial(jax.jit, static_argnames=("num_partitions",))
def assign_loglik_partitioned(g0, g1, af, site_weight, num_partitions: int):
    """Per-partition sums: ``[P, N, K]`` where partition p = sites with
    ``s % P == p``.  Requires the (padded) site count to be a multiple of P.
    """
    m, n = g0.shape
    k = af.shape[1]
    p = num_partitions
    assert m % p == 0, "site axis must be padded to a multiple of num_partitions"
    ll = site_loglik(g0[:, :, None], g1[:, :, None], af[:, None, :])
    ll = ll * site_weight[:, None, None]
    return jnp.sum(ll.reshape(m // p, p, n, k), axis=0)


@functools.partial(jax.jit, static_argnames=("num_partitions", "block"))
def _assign_loglik_partitioned_blocked(
    g0, g1, af, site_weight, num_partitions: int, block: int
):
    m, n = g0.shape
    k = af.shape[1]
    p = num_partitions
    ll = site_loglik(g0[:, :, None], g1[:, :, None], af[:, None, :])
    ll = ll * site_weight[:, None, None]
    q = m // p
    return jnp.sum(ll.reshape(q // block, block, p, n, k), axis=1)


def assign_loglik_partitioned_f64(
    g0, g1, af, site_weight, num_partitions: int
) -> np.ndarray:
    """Partitioned sums ``[P, N, K]`` with f64 site-axis accumulation."""
    m = g0.shape[0]
    assert m % num_partitions == 0
    block = _pick_block(m // num_partitions)
    parts = _assign_loglik_partitioned_blocked(
        g0, g1, af, site_weight, num_partitions, block
    )
    return fetch_to_host(parts).astype(np.float64).sum(axis=0)


@jax.jit
def assign_loglik_selected(g0, g1, af_bank_t, col_idx, site_weight):
    """Assignment log-likelihoods where each (individual, population) pair
    uses its own AF column from a bank — the general form needed for LOO with
    the reference's in-place AF-mutation semantics (glassy.py:87-98).

    Args:
      g0, g1: float32 ``[M, N]``.
      af_bank_t: float32 ``[C, M]`` bank of AF vectors, site-minor layout.
      col_idx: int32 ``[N, K]`` — bank row used for pair (i, k).
      site_weight: float32 ``[M]``.

    Returns: float32 ``[N, K]``.

    Scans over individuals so only a ``[K, M]`` gather is live at a time.
    """

    def one_ind(carry, inputs):
        i, idx_i = inputs  # scalar, [K]
        g0i = jax.lax.dynamic_index_in_dim(g0, i, axis=1, keepdims=False)
        g1i = jax.lax.dynamic_index_in_dim(g1, i, axis=1, keepdims=False)
        a = jnp.take(af_bank_t, idx_i, axis=0)  # [K, M]
        ll = site_loglik(g0i[None, :], g1i[None, :], a)
        ll = ll * site_weight[None, :]
        return carry, jnp.sum(ll, axis=1)

    n = g0.shape[1]
    _, out = jax.lax.scan(one_ind, None, (jnp.arange(n), col_idx))
    return out


@functools.partial(jax.jit, static_argnames=("block",))
def _assign_loglik_selected_blocked(
    g0, g1, af_bank_t, col_idx, site_weight, block: int
):
    """Blocked variant: per-individual ``[K, NB]`` f32 block partials,
    stacked to ``[N, K, NB]``."""
    m = g0.shape[0]

    def one_ind(carry, inputs):
        i, idx_i = inputs
        g0i = jax.lax.dynamic_index_in_dim(g0, i, axis=1, keepdims=False)
        g1i = jax.lax.dynamic_index_in_dim(g1, i, axis=1, keepdims=False)
        a = jnp.take(af_bank_t, idx_i, axis=0)  # [K, M]
        ll = site_loglik(g0i[None, :], g1i[None, :], a)
        ll = ll * site_weight[None, :]
        return carry, jnp.sum(ll.reshape(-1, m // block, block), axis=2)

    n = g0.shape[1]
    _, out = jax.lax.scan(one_ind, None, (jnp.arange(n), col_idx))
    return out


def assign_loglik_selected_f64(
    g0, g1, af_bank_t, col_idx, site_weight
) -> np.ndarray:
    """``[N, K]`` bank-selected log-likelihoods with f64 site accumulation
    (the LOO path's sum, reference glassy.py:101)."""
    block = _pick_block(g0.shape[0])
    parts = _assign_loglik_selected_blocked(
        g0, g1, af_bank_t, col_idx, site_weight, block
    )
    return fetch_to_host(parts).astype(np.float64).sum(axis=2)


@functools.partial(jax.jit, static_argnames=("num_partitions",))
def assign_loglik_selected_partitioned(
    g0, g1, af_bank_t, col_idx, site_weight, num_partitions: int
):
    """Partitioned variant of :func:`assign_loglik_selected`.

    Returns ``(ll [N, K], parts [N, P, K])``.
    """
    m, n = g0.shape
    p = num_partitions
    assert m % p == 0, "site axis must be padded to a multiple of num_partitions"

    def one_ind(carry, inputs):
        i, idx_i = inputs
        g0i = jax.lax.dynamic_index_in_dim(g0, i, axis=1, keepdims=False)
        g1i = jax.lax.dynamic_index_in_dim(g1, i, axis=1, keepdims=False)
        a = jnp.take(af_bank_t, idx_i, axis=0)  # [K, M]
        ll = site_loglik(g0i[None, :], g1i[None, :], a)
        ll = ll * site_weight[None, :]
        parts = jnp.sum(ll.reshape(-1, m // p, p), axis=1)  # [K, P]
        return carry, (jnp.sum(parts, axis=1), parts.T)

    _, (ll, parts) = jax.lax.scan(one_ind, None, (jnp.arange(n), col_idx))
    return ll, parts


@functools.partial(jax.jit, static_argnames=("num_partitions", "block"))
def _assign_loglik_selected_partitioned_blocked(
    g0, g1, af_bank_t, col_idx, site_weight, num_partitions: int, block: int
):
    """Blocked partitioned variant: ``[N, K, NB, P]`` f32 block partials."""
    m = g0.shape[0]
    p = num_partitions
    q = m // p

    def one_ind(carry, inputs):
        i, idx_i = inputs
        g0i = jax.lax.dynamic_index_in_dim(g0, i, axis=1, keepdims=False)
        g1i = jax.lax.dynamic_index_in_dim(g1, i, axis=1, keepdims=False)
        a = jnp.take(af_bank_t, idx_i, axis=0)
        ll = site_loglik(g0i[None, :], g1i[None, :], a)
        ll = ll * site_weight[None, :]
        return carry, jnp.sum(ll.reshape(-1, q // block, block, p), axis=2)

    n = g0.shape[1]
    _, out = jax.lax.scan(one_ind, None, (jnp.arange(n), col_idx))
    return out


def assign_loglik_selected_partitioned_f64(
    g0, g1, af_bank_t, col_idx, site_weight, num_partitions: int
):
    """``(ll [N, K], parts [N, P, K])`` with f64 site accumulation."""
    m = g0.shape[0]
    assert m % num_partitions == 0
    block = _pick_block(m // num_partitions)
    blocks = _assign_loglik_selected_partitioned_blocked(
        g0, g1, af_bank_t, col_idx, site_weight, num_partitions, block
    )
    parts = fetch_to_host(blocks).astype(np.float64).sum(axis=2)  # [N, K, P]
    return parts.sum(axis=2), np.transpose(parts, (0, 2, 1))
