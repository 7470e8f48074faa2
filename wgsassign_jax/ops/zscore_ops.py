"""Device kernels for the z-score statistic (reference zscore_cy.pyx).

Per kept site ``s`` of individual ``i`` with AF ``a`` and HWE genotype prior
``P = [(1-a)^2, 2a(1-a), a^2]``:

  observed:   W_obs  = sum_s log( GL_s · P_s )
  expected:   W_mu_s = sum_{splits c of depth D_s} lg(s,c) * wt(s,c)
  variance:   V_s    = sum_c (W_mu_s - lg(s,c))^2 * wt(s,c)

where for combo row c of the depth table,

  lg(s,c) = log( meanGL[c] · P_s )          (zscore_cy.pyx:31)
  wt(s,c) = P_s · readProb[c]               (zscore_cy.pyx:32-34)

and the final statistic is Z = (W_obs - ΣW_mu) / sqrt(ΣV)
(reference WGSassign.py:367-371).

The reference's per-site serial loop over depth splits becomes a static
``[S, C]`` gather from the (tiny) combo tables: the host precomputes, per
site, the table rows of all splits of its depth (``split_rows``) plus a
validity mask, both padded to a bucketed ``C`` so recompilation is bounded.

Note on the reference's transposed table lookup (``AD_index[Aa, Ar]`` vs the
``[Ar, Aa]`` build — zscore.py:71 / zscore_cy.pyx:30): because every split of
a kept depth is present, the transposed read only permutes the summation
order over splits, so totals are identical; we index consistently (and avoid
the reference's out-of-bounds read on non-square tables).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_F32 = jnp.float32


@jax.jit
def zscore_sums(g0k, g1k, a, weight, split_rows, split_mask, like_tab, fact_tab):
    """Masked sums for the z statistic.

    Args:
      g0k, g1k: float32 ``[S]`` kept-site GLs of the individual (padded).
      a: float32 ``[S]`` AF at kept sites (own-pop LOO or assigned-pop).
      weight: float32 ``[S]`` 1.0 for real kept sites.
      split_rows: int32 ``[S, C]`` combo-table row of each split of the
        site's depth (padding -> 0).
      split_mask: float32 ``[S, C]`` validity of each split entry.
      like_tab: float32 ``[R, 3]`` per-combo mean GL triple.
      fact_tab: float32 ``[R, 3]`` per-combo read probability under each
        genotype.

    Returns: ``(w_obs, w_mu, w_var)`` scalars (float32).
    """
    p0 = (1.0 - a) * (1.0 - a)
    p1 = 2.0 * (1.0 - a) * a
    p2 = a * a

    w_obs_site = jnp.log(g0k * p0 + g1k * p1 + (1.0 - g0k - g1k) * p2)

    mg = like_tab[split_rows]  # [S, C, 3]
    rp = fact_tab[split_rows]  # [S, C, 3]
    lg = jnp.log(
        mg[..., 0] * p0[:, None] + mg[..., 1] * p1[:, None] + mg[..., 2] * p2[:, None]
    )
    wt = (
        rp[..., 0] * p0[:, None] + rp[..., 1] * p1[:, None] + rp[..., 2] * p2[:, None]
    ) * split_mask
    w_mu_site = jnp.sum(lg * wt, axis=1)
    w_var_site = jnp.sum((w_mu_site[:, None] - lg) ** 2 * wt, axis=1)

    w_obs = jnp.sum(w_obs_site * weight)
    w_mu = jnp.sum(w_mu_site * weight)
    w_var = jnp.sum(w_var_site * weight)
    return w_obs, w_mu, w_var


@jax.jit
def zscore_sums_batch(g0k, g1k, a, weight, split_rows, split_mask,
                      like_tab, fact_tab):
    """A block of B individuals' z sums in one device pass (the reference
    runs a serial per-individual host loop, WGSassign.py:346-381).

    Same contract as :func:`zscore_sums` with a leading ``B`` axis on every
    operand (per-individual combo tables padded to shared ``[R, 3]``
    shapes); returns three ``[B]`` vectors.
    """
    return jax.vmap(zscore_sums)(
        g0k, g1k, a, weight, split_rows, split_mask, like_tab, fact_tab
    )


@jax.jit
def zscore_sums_batch_compact(g0k, g1k, a, weight, site_depth,
                              rows_by_depth, like_tab, fact_tab):
    """As :func:`zscore_sums_batch`, but the split tables are expanded ON
    DEVICE from compact per-site depths, with the split axis rolled into
    an unrolled C-step loop so only ``[S]`` temporaries are ever live.

    Two memory properties, both load-bearing at production scale:

    * the host-expanded ``[B, S, C]`` tables cost ``8·C`` bytes/site to
      ship host→device; the ``[B, S]`` int32 depth vector is
      4 bytes/site, and ``rows_by_depth`` (``[B, D, C]``, the combo-table
      row of split ``c`` at depth ``d``) is tiny.  The split mask is just
      ``c <= depth`` (all splits of a kept depth exist, by the depth-class
      filter).
    * the earlier ``[C, S]`` materialization held ~8 C-wide temporaries
      (~68·C bytes/site of HLO temps), which capped the z-sums block at
      b=1 individual at 2M sites, and its ``[S, C]``-shaped table
      gathers were costly.  The (depth, split) loop below has NEITHER
      problem: scalar table rows broadcast over [S], so the kernel is
      pure fusable elementwise work with a handful of [S] live buffers.
    """
    def one(g0k_i, g1k_i, a_i, w_i, d_i, rbd_i, lt_i, ft_i):
        c_max = rbd_i.shape[1]
        p0 = (1.0 - a_i) * (1.0 - a_i)
        p1 = 2.0 * (1.0 - a_i) * a_i
        p2 = a_i * a_i
        w_obs_site = jnp.log(
            g0k_i * p0 + g1k_i * p1 + (1.0 - g0k_i - g1k_i) * p2
        )

        # Key structure: for a FIXED (depth d, split x) the combo-table
        # row is one SCALAR index (rbd_i[d, x]), so the mean-GL/read-prob
        # values broadcast as scalars and each term is pure elementwise
        # [S] math — no [S]-wide gathers at all.  Sites select their depth's terms via (d_i == d)
        # masks; the log term is recomputed in the variance pass instead
        # of held, keeping live temporaries to a handful of [S] buffers.
        def lgwt(d, x):
            mg = lt_i[rbd_i[d, x]]   # [3] — scalar dynamic row
            rp = ft_i[rbd_i[d, x]]
            lg = jnp.log(mg[0] * p0 + mg[1] * p1 + mg[2] * p2)
            wt = rp[0] * p0 + rp[1] * p1 + rp[2] * p2
            return lg, wt

        w_mu_site = jnp.zeros_like(a_i)
        for d in range(c_max):
            mask_d = (d_i == d).astype(_F32)
            acc = jnp.zeros_like(a_i)
            for x in range(d + 1):
                lg, wt = lgwt(d, x)
                acc = acc + lg * wt
            w_mu_site = w_mu_site + mask_d * acc
        w_var_site = jnp.zeros_like(a_i)
        for d in range(c_max):
            mask_d = (d_i == d).astype(_F32)
            acc = jnp.zeros_like(a_i)
            for x in range(d + 1):
                lg, wt = lgwt(d, x)
                acc = acc + (w_mu_site - lg) ** 2 * wt
            w_var_site = w_var_site + mask_d * acc

        return (
            jnp.sum(w_obs_site * w_i),
            jnp.sum(w_mu_site * w_i),
            jnp.sum(w_var_site * w_i),
        )

    return jax.vmap(one)(
        g0k, g1k, a, weight, site_depth, rows_by_depth, like_tab, fact_tab
    )
