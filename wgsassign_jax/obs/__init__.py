from wgsassign_jax.obs.profiling import RunTimer, maybe_profile

__all__ = ["RunTimer", "maybe_profile"]
