#!/usr/bin/env bash
# External validation: run the ORIGINAL WGSassign and this engine on the
# bundled amre data and compare every output.
#
# The committed golden fixtures (tests/golden/) were generated from
# tests/oracle.py — an openly-cited NumPy restatement of the reference
# semantics, cross-checked by an independent serial second oracle
# (tests/test_second_oracle.py) — because the reference's Cython extensions
# cannot be built in the development environment (no older-numpy toolchain,
# no network).  On any normal machine, this script closes that loop against
# the actual reference binary:
#
#   ./scripts/validate_against_reference.sh /path/to/WGSassign-checkout
#
# Requires: a python env able to `pip install` the reference checkout
# (numpy<=1.22.3 per its README), plus this repo on PYTHONPATH.
set -euo pipefail

REF_CHECKOUT=${1:?usage: $0 /path/to/WGSassign-checkout [workdir]}
WORK=${2:-$(mktemp -d)}
HERE=$(cd "$(dirname "$0")/.." && pwd)
DATA="$REF_CHECKOUT/data"
BEAGLE="$DATA/amre.breeding.ind85.ds_2x.sites-filter.top_50_each.beagle.gz"
IDS="$DATA/amre.breeding.ind85.reference_k5.IDs.txt"
DS="$DATA/amre.breeding.ind85.ds_2x.sites-filter.top_50_each.subset_80percent_sites.beagle.gz"
NB="$DATA/amre.nonbreeding.ind34.ds_2x.sites-filter.breeding-top-50.beagle.gz"

echo "== installing reference from $REF_CHECKOUT"
pip install "$REF_CHECKOUT"

run_both() {  # name, then identical flags for both CLIs
  local name=$1; shift
  echo "== $name"
  WGSassign "$@" --out "$WORK/ref_$name"
  python -m wgsassign_jax.cli "$@" --out "$WORK/new_$name"
}

run_both refaf  --beagle "$BEAGLE" --pop_af_IDs "$IDS" --get_reference_af --ne_obs
run_both loo    --beagle "$BEAGLE" --pop_af_IDs "$IDS" --get_reference_af --loo
run_both loods  --beagle "$BEAGLE" --pop_af_IDs "$IDS" --get_reference_af --loo \
                --loo_downsampled_beagle "$DS"
run_both plike  --beagle "$NB" --pop_af_file "$WORK/ref_refaf.pop_af.npy" --get_pop_like

python - "$WORK" << 'PY'
import sys, numpy as np, pandas as pd
w = sys.argv[1]
def close(a, b, what, rtol=1e-4, atol=2e-3):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)
    print(f"OK  {what}")

close(np.load(f"{w}/ref_refaf.pop_af.npy"), np.load(f"{w}/new_refaf.pop_af.npy"),
      "pop_af.npy", atol=2e-4)
assert open(f"{w}/ref_refaf.pop_names.txt").read() == \
       open(f"{w}/new_refaf.pop_names.txt").read()
print("OK  pop_names.txt")
close(np.load(f"{w}/ref_refaf.ne_obs.npy"), np.load(f"{w}/new_refaf.ne_obs.npy"),
      "ne_obs.npy")
close(np.loadtxt(f"{w}/ref_refaf.ne_ind.txt"), np.loadtxt(f"{w}/new_refaf.ne_ind.txt"),
      "ne_ind.txt")
for name, f in (("loo", "pop_like_LOO.tsv"), ("loods", "pop_like_LOO_downsampled.tsv")):
    r = pd.read_csv(f"{w}/ref_{name}.{f}", sep="\t")
    t = pd.read_csv(f"{w}/new_{name}.{f}", sep="\t")
    assert list(r.columns) == list(t.columns)
    rv, tv = r.iloc[:, 2:].to_numpy(float), t.iloc[:, 2:].to_numpy(float)
    close(rv, tv, f)
    assert (rv.argmax(1) == tv.argmax(1)).all(); print(f"OK  {f} argmax")
close(np.loadtxt(f"{w}/ref_plike.pop_like.txt"), np.loadtxt(f"{w}/new_plike.pop_like.txt"),
      "pop_like.txt")
print("\nAll reference-vs-engine comparisons passed.")
PY
