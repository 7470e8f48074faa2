from wgsassign_jax.parallel.mesh import Runtime, make_runtime

__all__ = ["Runtime", "make_runtime"]
