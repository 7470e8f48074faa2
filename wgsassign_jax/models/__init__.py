from wgsassign_jax.models.common import DeviceCohort, to_device
from wgsassign_jax.models.reference_af import estimate_reference_af
from wgsassign_jax.models.assign import assignment_loglikelihoods
from wgsassign_jax.models.loo import leave_one_out
from wgsassign_jax.models.ne import effective_sample_sizes

__all__ = [
    "DeviceCohort",
    "to_device",
    "estimate_reference_af",
    "assignment_loglikelihoods",
    "leave_one_out",
    "effective_sample_sizes",
]
