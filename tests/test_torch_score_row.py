"""A numpy model of kernel 7's word loader (``csrc/xt_dots_t.cu``, layout
ROW): the stage tile that its 16-byte copies build from the row-major
words, and the A fragments each thread reads from it.

Kernel 7 is kernel 2's body with another loader, so it is right where its
fragments are kernel 2's: for every thread, K step and register, the word
the ROW loader hands it must be the one the T loader hands it from
``words_t = words.T`` (zero past the array on both), and a warp's 32 reads
of one register must fall in 32 shared-memory banks.  The model mirrors the
kernel's constants: ``row_words``, the K steps a stage (``stage_steps``),
the tile of 128 SNPs (64 when the warpgroups split the rows).
"""

import numpy as np
import pytest

# xt_dots_t.cu: stage_steps<NG>() for NG = 0 (m <= 2), 1-2, and 4 or more
STAGE_STEPS = (4, 2, 1)
BANKS = 32


def row_words(ks):
    """The uint32 stride of a ROW stage's SNP row: 8*ks words + 4 pad."""
    return 8 * ks + 4


def _row_stage(words, snp0, snps, ks, ls):
    """The ROW loader's words tile of stage ``ls`` of the tile at ``snp0``:
    SNP row r, 16-byte chunk c <- words[snp0 + r, w0 + 4c ..], zero-filled
    where the row or the chunk lies past the array."""
    p, nw = words.shape
    stride = row_words(ks)
    tile = np.full((snps, stride), 0xDEADBEEF, dtype=np.uint32)  # pad: junk
    w0 = 8 * ks * ls
    kc = 2 * ks
    for i in range(kc * snps):
        r, c = divmod(i, kc)
        assert (r * stride + 4 * c) * 4 % 16 == 0          # cp.async16
        ok = snp0 + r < p and w0 + 4 * c < nw
        tile[r, 4 * c:4 * c + 4] = (words[snp0 + r, w0 + 4 * c:w0 + 4 * c + 4]
                                    if ok else 0)
    return tile


def _t_stage(words_t, snp0, snps, ks, ls):
    """The T loader's words tile: transposed-word row r, 16-byte chunk c
    (SNPs 4c ..) <- words_t[w0 + r, snp0 + 4c ..], rows of snps + 8."""
    nw, p_all = words_t.shape
    tile = np.full((8 * ks, snps + 8), 0xDEADBEEF, dtype=np.uint32)
    w0 = 8 * ks * ls
    for i in range(8 * ks * snps // 4):
        r, c = divmod(i, snps // 4)
        ok = w0 + r < nw and 4 * c < p_all - snp0
        tile[r, 4 * c:4 * c + 4] = (
            words_t[w0 + r, snp0 + 4 * c:snp0 + 4 * c + 4] if ok else 0)
    return tile


def _row_reads(sl, s, t):
    """(row, word) of the ROW decode's four registers: words t and 4+t of K
    step s, rows sl and sl+8."""
    return [(sl, 8 * s + t), (sl + 8, 8 * s + t), (sl, 8 * s + 4 + t),
            (sl + 8, 8 * s + 4 + t)]


def _threads(split):
    """(t, the SNP of MMA row g in the tile) of every thread (warpgroup,
    warp, g, t) of a block."""
    for wg in range(2):
        snp_off = 0 if split else 64 * wg
        for warp in range(4):
            for g in range(8):
                for t in range(4):
                    yield t, snp_off + 16 * warp + g


@pytest.mark.parametrize("ks", STAGE_STEPS)
@pytest.mark.parametrize("split", [False, True])
def test_row_fragments_equal_transposed_fragments(ks, split):
    """Every thread's four A-fragment words of every K step, from the ROW
    tile of random row-major words (p and nw ragged against the tile and
    the stage), equal the T loader's from their transpose."""
    rng = np.random.default_rng(10 * ks + split)
    snps = 64 if split else 128
    p, nw = 2 * snps + 36, 8 * ks * 3 + 4     # last tile and stage ragged
    words = rng.integers(0, 2**32, size=(p, nw), dtype=np.uint64)
    words = words.astype(np.uint32)
    words_t = np.zeros((nw, p), dtype=np.uint32)
    words_t[:] = words.T                      # p % 4 == 0: no pad needed
    stages = -(-nw // (8 * ks))
    for snp0 in range(0, p, snps):
        for ls in range(stages):
            row = _row_stage(words, snp0, snps, ks, ls)
            tt = _t_stage(words_t, snp0, snps, ks, ls)
            for t, sl in _threads(split):
                for s in range(ks):
                    got = [row[r, w] for r, w in _row_reads(sl, s, t)]
                    want = [tt[8 * s + t, sl], tt[8 * s + t, sl + 8],
                            tt[8 * s + 4 + t, sl], tt[8 * s + 4 + t, sl + 8]]
                    assert got == want
                    # and the words themselves, zero past the array
                    w = 8 * (ks * ls + s) + t
                    for (r, kw), x in zip(((sl, 0), (sl + 8, 0), (sl, 4),
                                           (sl + 8, 4)), got):
                        j = snp0 + r
                        ref = words[j, w + kw] if j < p and w + kw < nw else 0
                        assert x == ref


@pytest.mark.parametrize("ks", STAGE_STEPS)
def test_row_fragment_reads_free_of_bank_conflicts(ks):
    """A warp's 32 reads of one fragment register (rows g, words t) fall in
    32 banks with the padded stride, while the unpadded 8*ks-word row puts
    rows g and g+4 (ks = 1) in one bank."""
    for stride, free in ((row_words(ks), True), (8 * ks, False)):
        for warp in range(4):
            for reg in range(4):
                for s in range(ks):
                    banks = set()
                    for g in range(8):
                        for t in range(4):
                            sl = 16 * warp + g
                            r, w = _row_reads(sl, s, t)[reg]
                            banks.add((r * stride + w) % BANKS)
                    assert (len(banks) == BANKS) == free, (stride, reg, s)
