from wgsassign_jax.io.beagle import BeagleData, read_beagle
from wgsassign_jax.io.ids import PopulationMap, read_ids

__all__ = ["BeagleData", "read_beagle", "PopulationMap", "read_ids"]
