from wgsassign_jax.ops.emmaf import (
    em_weights,
    em_maf_pops,
    em_maf_loo_group,
    clamp_af,
)
from wgsassign_jax.ops.loglik import (
    site_loglik,
    assign_loglik,
    assign_loglik_partitioned,
)

__all__ = [
    "em_weights",
    "em_maf_pops",
    "em_maf_loo_group",
    "clamp_af",
    "site_loglik",
    "assign_loglik",
    "assign_loglik_partitioned",
]
