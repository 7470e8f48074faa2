"""Allele-frequency EM ops (the MAF EM of reference emMAF.py / emMAF_cy.pyx).

Model: per site ``s`` with minor-allele frequency ``f`` under HWE, the
genotype prior is ``P(g=0)=(1-f)^2, P(g=1)=2f(1-f), P(g=2)=f^2``.  The EM
update over individuals with genotype likelihoods ``(g0, g1, g2=1-g0-g1)``:

    w_i = (p1 + 2*p2) / (2*(p0 + p1 + p2)),  p_g = gl_g * P(g)
    f'  = mean_i w_i

(reference emMAF_cy.pyx:10-23).  Convergence: RMSE(f', f) < tol, all sites
iterating together (reference emMAF.py:15-27).

Design — instead of the reference's serial per-pop loop we run **all K
populations' EMs simultaneously**:

  * ``f`` is an ``[M, K]`` panel, sharded over the SNP axis;
  * each individual's current AF is a bit-exact ``take`` gather of its
    population's column;
  * per-pop sums are the matmul ``w @ membership`` at HIGHEST precision;
  * per-pop convergence masks freeze finished populations so iteration
    counts per pop match independent runs exactly.

The leave-one-out variant batches all ``n_p`` LOO problems of one population
as an ``[M, n_p]`` panel with an off-diagonal membership mask.

All ops are pure jittable functions; cross-device reduction (the per-pop RMSE
partials) is inserted automatically by GSPMD when inputs carry a SNP-axis
sharding.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

_F32 = jnp.float32

# The EM iterate lives in the open interval (0, 1): at f == 1.0 exactly the
# weight denominator g0(1-f)^2 + 2 g1 f(1-f) + g2 f^2 vanishes for members
# with g2 == 0 (0/0 -> NaN), and float32 rounding of the member mean *can*
# land exactly on 1.0.  Clipping each update one ulp-scale inside the
# interval keeps the denominator provably positive without perturbing the
# trajectory at the 1e-4 convergence tolerance.
_EM_EPS = 1e-7


def em_weights(g0, g1, f):
    """Per-(site, individual) posterior expected minor-allele dosage / 2.

    ``g0``/``g1`` and ``f`` must broadcast against each other.  Returns
    ``(p1 + 2 p2) / (2 (p0 + p1 + p2))`` with ``g2 = 1 - g0 - g1``.
    """
    omf = 1.0 - f
    p0 = g0 * omf * omf
    p1 = g1 * 2.0 * f * omf
    p2 = (1.0 - g0 - g1) * f * f
    return (p1 + 2.0 * p2) / (2.0 * (p0 + p1 + p2))


def _masked_rmse(f_new, f_old, site_weight, m_real):
    """Per-column RMSE over real (unpadded) sites: sqrt(sum(w*(d^2))/m)."""
    d = f_new - f_old
    sq = jnp.sum(d * d * site_weight[:, None], axis=0)
    return jnp.sqrt(sq / m_real)


@functools.partial(
    jax.jit, static_argnames=("max_iter",)
)
def em_maf_pops(
    g0: jax.Array,
    g1: jax.Array,
    membership: jax.Array,
    pop_index: jax.Array,
    site_weight: jax.Array,
    m_real,
    max_iter: int,
    tol,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Run the MAF EM for all populations at once.

    Args:
      g0, g1: float32 ``[M, N]`` genotype likelihoods (M may be padded).
      membership: float32 ``[N, K]`` one-hot population membership.
      pop_index: int32 ``[N]`` population index per individual.
      site_weight: float32 ``[M]`` — 1.0 for real sites, 0.0 for padding.
      m_real: scalar — number of real sites (for the RMSE denominator).
      max_iter: maximum EM iterations (reference default 200).
      tol: RMSE convergence tolerance (reference default 1e-4).

    Returns:
      ``(f [M, K], iters [K] int32, converged [K] bool)`` where ``iters`` is
      the 1-based iteration at which each population converged (or
      ``max_iter`` if it did not).

    Precision note: the per-individual AF lookup is a ``take`` (bit-exact),
    and the member sum runs at ``Precision.HIGHEST`` — a reduced-precision
    product (TF32 on a GPU) would quantize the EM trajectory far beyond the
    1e-4 convergence tolerance.
    """
    m, n = g0.shape
    k = membership.shape[1]
    counts = jnp.sum(membership, axis=0)  # [K]
    inv_counts = 1.0 / counts
    tol = jnp.asarray(tol, _F32)
    m_real = jnp.asarray(m_real, _F32)

    f0 = jnp.full((m, k), 0.25, dtype=_F32)

    def update(f):
        f_ind = jnp.take(f, pop_index, axis=1)  # [M, N], exact gather
        w = em_weights(g0, g1, f_ind)
        f_new = (
            jnp.dot(w, membership, precision=jax.lax.Precision.HIGHEST)
            * inv_counts
        )
        return jnp.clip(f_new, _EM_EPS, 1.0 - _EM_EPS)

    def cond(state):
        _, active, _, it = state
        return jnp.logical_and(it < max_iter, jnp.any(active))

    def body(state):
        f, active, iters, it = state
        f_upd = update(f)
        f_new = jnp.where(active[None, :], f_upd, f)
        diff = _masked_rmse(f_new, f, site_weight, m_real)
        newly = jnp.logical_and(active, diff < tol)
        iters = jnp.where(newly, it + 1, iters)
        active = jnp.logical_and(active, diff >= tol)
        return f_new, active, iters, it + 1

    state = (
        f0,
        jnp.ones((k,), dtype=bool),
        jnp.full((k,), max_iter, dtype=jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    f, active, iters, _ = jax.lax.while_loop(cond, body, state)
    return f, iters, jnp.logical_not(active)


@functools.partial(jax.jit, static_argnames=("max_iter",))
def em_maf_loo_group(
    g0p: jax.Array,
    g1p: jax.Array,
    site_weight: jax.Array,
    m_real,
    max_iter: int,
    tol,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Batched leave-one-out MAF EM for one population.

    For a population with members ``0..n_p-1`` (rows of ``g0p``/``g1p``,
    shape ``[n_p, M]``), runs the ``n_p`` independent
    EMs in which member ``j`` is left out, all at once.  Equivalent to the
    reference's N serial full EM re-runs (glassy.py:65-89) but one batched
    computation.

    Returns ``(f [n_p, M], iters [n_p], converged [n_p])`` — row ``j`` is
    the leave-``j``-out allele frequency.
    """
    npop, m = g0p.shape
    # mask[i, j] = 1 if member i participates in problem j (i != j)
    mask = 1.0 - jnp.eye(npop, dtype=_F32)
    inv_counts = 1.0 / (npop - 1.0)
    tol = jnp.asarray(tol, _F32)
    m_real = jnp.asarray(m_real, _F32)

    f0 = jnp.full((npop, m), 0.25, dtype=_F32)

    def update(f):
        # w[i, j, s] = em weight of member i under problem j's current AF.
        w = em_weights(g0p[:, None, :], g1p[:, None, :], f[None, :, :])
        # Masked mean over members i != j.  The elementwise producer fuses
        # into this reduction, so the [n_p, n_p, M] tensor never
        # materializes.
        f_new = jnp.sum(w * mask[:, :, None], axis=0) * inv_counts
        return jnp.clip(f_new, _EM_EPS, 1.0 - _EM_EPS)

    def cond(state):
        _, active, _, it = state
        return jnp.logical_and(it < max_iter, jnp.any(active))

    def body(state):
        f, active, iters, it = state
        f_upd = update(f)
        f_new = jnp.where(active[:, None], f_upd, f)
        d = f_new - f
        sq = jnp.sum(d * d * site_weight[None, :], axis=1)
        diff = jnp.sqrt(sq / m_real)
        newly = jnp.logical_and(active, diff < tol)
        iters = jnp.where(newly, it + 1, iters)
        active = jnp.logical_and(active, diff >= tol)
        return f_new, active, iters, it + 1

    state = (
        f0,
        jnp.ones((npop,), dtype=bool),
        jnp.full((npop,), max_iter, dtype=jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    f, active, iters, _ = jax.lax.while_loop(cond, body, state)
    return f, iters, jnp.logical_not(active)


@functools.partial(jax.jit, static_argnames=("max_iter",))
def em_maf_sites_batch(
    g0p: jax.Array,
    g1p: jax.Array,
    member_mask: jax.Array,
    site_weight: jax.Array,
    m_real: jax.Array,
    max_iter: int,
    tol,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """``B`` independent one-population MAF EMs over per-problem site subsets.

    The z-score reference mode re-runs a leave-one-out EM per individual on
    that individual's kept loci (reference WGSassign.py:352-364, a serial
    host loop).  Here a block of B individuals runs as one batched device
    computation: problem ``b`` iterates over its own gathered ``[P, S]``
    member panel with its own site mask and RMSE denominator, converging
    independently (same per-problem semantics as :func:`em_maf_pops`).

    Args:
      g0p, g1p: float32 ``[B, P, S]`` member GLs at each problem's kept
        sites (padded site slots must carry a valid GL pattern).
      member_mask: float32 ``[B, P]`` — 1 where the member participates
        (excludes the focal individual; rows of an all-dummy problem may be
        zero — guarded against 0-division).
      site_weight: float32 ``[B, S]`` — 1 for real kept sites.
      m_real: float32 ``[B]`` per-problem real-site counts (>= 1).

    Returns ``(f [B, S], iters [B] int32, converged [B] bool)``.
    """
    b, p, s = g0p.shape
    counts = jnp.sum(member_mask, axis=1)  # [B]
    inv_counts = 1.0 / jnp.maximum(counts, 1.0)
    tol = jnp.asarray(tol, _F32)
    m_real = jnp.asarray(m_real, _F32)

    f0 = jnp.full((b, s), 0.25, dtype=_F32)

    def update(f):
        w = em_weights(g0p, g1p, f[:, None, :])  # [B, P, S], fuses into sum
        f_new = (
            jnp.sum(w * member_mask[:, :, None], axis=1) * inv_counts[:, None]
        )
        return jnp.clip(f_new, _EM_EPS, 1.0 - _EM_EPS)

    def cond(state):
        _, active, _, it = state
        return jnp.logical_and(it < max_iter, jnp.any(active))

    def body(state):
        f, active, iters, it = state
        f_upd = update(f)
        f_new = jnp.where(active[:, None], f_upd, f)
        d = f_new - f
        sq = jnp.sum(d * d * site_weight, axis=1)
        diff = jnp.sqrt(sq / m_real)
        newly = jnp.logical_and(active, diff < tol)
        iters = jnp.where(newly, it + 1, iters)
        active = jnp.logical_and(active, diff >= tol)
        return f_new, active, iters, it + 1

    state = (
        f0,
        jnp.ones((b,), dtype=bool),
        jnp.full((b,), max_iter, dtype=jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    f, active, iters, _ = jax.lax.while_loop(cond, body, state)
    return f, iters, jnp.logical_not(active)


@functools.partial(jax.jit, static_argnames=("max_iter",))
def em_maf_loo_subset(
    g0p: jax.Array,
    g1p: jax.Array,
    leave_out: jax.Array,
    site_weight: jax.Array,
    m_real: jax.Array,
    max_iter: int,
    tol,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """``B`` leave-one-out MAF EMs of one population over the full site axis.

    The shard-local reformulation of :func:`em_maf_sites_batch` for the
    z-score reference mode (VERDICT r4: the ``[B, P, S]`` kept-site gather
    dominates multi-device z-scores — measured 0.33 s -> 0.86 s across 8
    shards while the EM itself scaled).  Because the EM is per-site
    independent, running problem ``b`` over *all* sites with its kept-site
    mask applied only to the convergence partials yields the identical
    trajectory at the kept sites — and the member panel is then just a
    shard-local column ``take`` of the cohort shared by every problem of
    the population, with zero cross-shard data motion (the final
    ``[B, S]`` kept-value gather is P-times smaller than the panel
    gather).

    Args:
      g0p, g1p: float32 ``[n_p, M]`` the population's member GLs,
        site-minor (as in :func:`em_maf_loo_group`).
      leave_out: int32 ``[B]`` member row left out by each problem.
      site_weight: float32 ``[B, M]`` per-problem kept-site mask (also 0
        on padded sites) — enters the convergence partials only.
      m_real: float32 ``[B]`` per-problem kept-site counts (>= 1).

    Returns ``(f [B, M], iters [B] int32, converged [B] bool)``.
    """
    npop, _m = g0p.shape
    b = leave_out.shape[0]
    mask = 1.0 - jax.nn.one_hot(leave_out, npop, dtype=_F32)  # [B, n_p]
    inv_counts = 1.0 / (npop - 1.0)
    tol = jnp.asarray(tol, _F32)
    m_real = jnp.asarray(m_real, _F32)

    f0 = jnp.full((b, g0p.shape[1]), 0.25, dtype=_F32)

    def update(f):
        # w[b, i, s] fuses into the masked member sum — the [B, n_p, M]
        # tensor never materializes
        w = em_weights(g0p[None], g1p[None], f[:, None, :])
        f_new = jnp.sum(w * mask[:, :, None], axis=1) * inv_counts
        return jnp.clip(f_new, _EM_EPS, 1.0 - _EM_EPS)

    def cond(state):
        _, active, _, it = state
        return jnp.logical_and(it < max_iter, jnp.any(active))

    def body(state):
        f, active, iters, it = state
        f_upd = update(f)
        f_new = jnp.where(active[:, None], f_upd, f)
        d = f_new - f
        sq = jnp.sum(d * d * site_weight, axis=1)
        diff = jnp.sqrt(sq / m_real)
        newly = jnp.logical_and(active, diff < tol)
        iters = jnp.where(newly, it + 1, iters)
        active = jnp.logical_and(active, diff >= tol)
        return f_new, active, iters, it + 1

    state = (
        f0,
        jnp.ones((b,), dtype=bool),
        jnp.full((b,), max_iter, dtype=jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    f, active, iters, _ = jax.lax.while_loop(cond, body, state)
    return f, iters, jnp.logical_not(active)


def clamp_af(f: jax.Array, n_pop) -> jax.Array:
    """Clamp allele frequencies to ``[1/(2(n+1)), 1 - 1/(2(n+1))]``.

    ``n_pop`` may be a scalar or a per-column ``[K]`` vector of sample sizes
    (reference WGSassign.py:236-240, glassy.py:80-85).
    """
    n_pop = jnp.asarray(n_pop, _F32)
    min_val = 1.0 / (2.0 * (n_pop + 1.0))
    return jnp.clip(f, min_val, 1.0 - min_val)
