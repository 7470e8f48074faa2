"""Wall-clock to converge the reference-AF run on the seeded 449-site x 85
individual test cohort (the amre example's shape) — the second
BASELINE.md north-star number.  Prints one JSON line."""

from __future__ import annotations

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

DATA = pathlib.Path(__file__).resolve().parent.parent / "tests" / "data"


def main():
    import jax

    from wgsassign_jax.io.beagle import read_beagle
    from wgsassign_jax.io.ids import read_ids
    from wgsassign_jax.models.reference_af import estimate_reference_af
    from wgsassign_jax.models.common import to_device
    from wgsassign_jax.parallel.mesh import make_runtime

    beagle = read_beagle(str(DATA / "breeding.ind85.beagle.gz"))
    popmap = read_ids(str(DATA / "breeding.ind85.reference_k5.IDs.txt"))
    rt = make_runtime(jax.devices()[:1])
    cohort = to_device(beagle, rt)
    # warmup (compile)
    estimate_reference_af(beagle, popmap, cohort=cohort)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        res = estimate_reference_af(beagle, popmap, cohort=cohort)
        best = min(best, time.perf_counter() - t0)
    print(json.dumps({
        "metric": "ind85_reference_af_wallclock",
        "value": round(best, 4),
        "unit": "s",
        "iters": [int(x) for x in res.iters],
    }))


if __name__ == "__main__":
    main()
