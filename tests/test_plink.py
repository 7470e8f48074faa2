import numpy as np

from wgsassign_jax.io.plink import read_plink_bed


def _write_plink(tmp_path, geno):
    """geno: [M, N] with 9=missing."""
    m, n = geno.shape
    code_of = {2: 0b00, 9: 0b01, 1: 0b10, 0: 0b11}
    bytes_per_site = (n + 3) // 4
    body = np.zeros((m, bytes_per_site), dtype=np.uint8)
    for s in range(m):
        for i in range(n):
            body[s, i // 4] |= code_of[int(geno[s, i])] << (2 * (i % 4))
    (tmp_path / "x.bed").write_bytes(b"\x6c\x1b\x01" + body.tobytes())
    with open(tmp_path / "x.fam", "w") as f:
        for i in range(n):
            f.write(f"F{i} I{i} 0 0 0 -9\n")
    with open(tmp_path / "x.bim", "w") as f:
        for s in range(m):
            f.write(f"1 snp{s} 0 {100+s} A C\n")
    return str(tmp_path / "x")


def test_plink_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    geno = rng.integers(0, 3, size=(7, 6))
    geno[2, 3] = 9
    prefix = _write_plink(tmp_path, geno)
    d = read_plink_bed(prefix, error_rate=0.01)
    assert d.gl.shape == (7, 6, 2)
    assert d.sample_names == [f"I{i}" for i in range(6)]
    assert d.site_names[0] == "1_100"
    e = 0.01
    exp = {
        0: [(1 - e) ** 2, 2 * e * (1 - e)],
        1: [(1 - e) * e, (1 - e) ** 2 + e**2],
        2: [e**2, 2 * e * (1 - e)],
    }
    for s in range(7):
        for i in range(6):
            g = int(geno[s, i])
            want = [1 / 3, 1 / 3] if g == 9 else exp[g]
            np.testing.assert_allclose(d.gl[s, i], want, rtol=1e-6)


def test_allele_counts_cli(tmp_path):
    """The AD preprocessing tool (reference allele_counts_beagle.py)."""
    import gzip

    from wgsassign_jax.io.ad import main as ad_main

    m, n = 4, 3
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 5, size=(m, 4 * n))
    codes = rng.integers(0, 4, size=(m, 2))
    while (codes[:, 0] == codes[:, 1]).any():
        codes = rng.integers(0, 4, size=(m, 2))
    with gzip.open(tmp_path / "raw.counts.gz", "wt") as f:
        f.write("header line\n")
        np.savetxt(f, raw, fmt="%d")
    with open(tmp_path / "sites.txt", "w") as f:
        f.write("marker\tallele1\tallele2\n")
        for s in range(m):
            f.write(f"s{s}\t{codes[s,0]}\t{codes[s,1]}\n")
    out = tmp_path / "out.txt.gz"
    ad_main([str(tmp_path / "raw.counts.gz"), str(tmp_path / "sites.txt"), str(out)])
    got = np.loadtxt(out, dtype=int)
    for s in range(m):
        for i in range(n):
            assert got[s, 2 * i] == raw[s, 4 * i + codes[s, 0]]
            assert got[s, 2 * i + 1] == raw[s, 4 * i + codes[s, 1]]
