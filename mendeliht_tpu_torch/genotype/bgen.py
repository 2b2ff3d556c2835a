"""Minimal BGEN v1.2/1.3 reader (zlib-compressed, biallelic) — replaces the
reference's BGEN.jl ingestion (reference src/wrapper.jl:365-398, :462-468).

Returns ALT-allele dosages (the reference flips first_allele_dosage! so that
ALT counts as 1; src/wrapper.jl:380-382).  A copy of the JAX package's
``genotype/bgen.py`` (numpy only), so that this package never imports that
one."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _read_cstr(buf, off, ln):
    return buf[off:off + ln].decode("utf-8", "replace")


def read_bgen(path: str, sample_path: str | None = None):
    """Parse a BGEN file. Supports layout 2 (v1.2/1.3) with zlib or no
    compression, 8/16/32-bit probabilities, biallelic diploid variants; and
    layout 1 (v1.1) zlib/uncompressed.

    Returns (G (n, p) float64 dosage of ALT with NaN missing, sample_ids,
    chr, pos, ids, ref, alt)."""
    with open(path, "rb") as f:
        data = f.read()
    (offset,) = struct.unpack_from("<I", data, 0)
    (hlen, n_var, n_samp, magic) = struct.unpack_from("<III4s", data, 4)
    if magic not in (b"bgen", b"\x00\x00\x00\x00"):
        raise ValueError(f"{path}: bad BGEN magic {magic!r}")
    (flags,) = struct.unpack_from("<I", data, 4 + hlen - 4)
    compression = flags & 0x3
    layout = (flags >> 2) & 0xF
    has_samples = (flags >> 31) & 0x1
    if compression == 2:
        if layout == 1:
            raise ValueError("BGEN layout 1 does not allow zstd compression")
        try:
            import zstandard as _zstd
        except ImportError as e:  # pragma: no cover - env without zstandard
            raise NotImplementedError(
                "zstd-compressed BGEN requires the 'zstandard' package") from e

    pos_ = 4 + hlen
    sample_ids = None
    if has_samples:
        (blk_len, n_s) = struct.unpack_from("<II", data, pos_)
        off = pos_ + 8
        ids = []
        for _ in range(n_s):
            (ln,) = struct.unpack_from("<H", data, off)
            off += 2
            ids.append(_read_cstr(data, off, ln))
            off += ln
        sample_ids = np.array(ids)
        pos_ = pos_ + 4 + blk_len - 4
    if sample_ids is None and sample_path:
        rows = [l.split() for l in open(sample_path).read().splitlines() if l.strip()]
        sample_ids = np.array([r[0] for r in rows[2:]])  # skip 2 header lines
    if sample_ids is None:
        sample_ids = np.array([str(i) for i in range(1, n_samp + 1)])

    pos_ = offset + 4
    G = np.full((n_samp, n_var), np.nan)
    chrs, posns, vids, refs, alts = [], [], [], [], []
    for v in range(n_var):
        if layout == 1:
            (nrow,) = struct.unpack_from("<I", data, pos_)
            pos_ += 4
        (ln,) = struct.unpack_from("<H", data, pos_)
        pos_ += 2 + ln  # variant id (skip)
        (ln,) = struct.unpack_from("<H", data, pos_)
        rsid = _read_cstr(data, pos_ + 2, ln)
        pos_ += 2 + ln
        (ln,) = struct.unpack_from("<H", data, pos_)
        chrom = _read_cstr(data, pos_ + 2, ln)
        pos_ += 2 + ln
        (vpos,) = struct.unpack_from("<I", data, pos_)
        pos_ += 4
        if layout == 1:
            n_alleles = 2
        else:
            (n_alleles,) = struct.unpack_from("<H", data, pos_)
            pos_ += 2
        alleles = []
        for _ in range(n_alleles):
            (aln,) = struct.unpack_from("<I", data, pos_)
            alleles.append(_read_cstr(data, pos_ + 4, aln))
            pos_ += 4 + aln
        if n_alleles != 2:
            raise ValueError(f"Marker {v + 1} of BGEN is not biallelic!")

        if layout == 1:
            if compression == 1:
                (clen,) = struct.unpack_from("<I", data, pos_)
                pos_ += 4
                raw = zlib.decompress(data[pos_:pos_ + clen])
                pos_ += clen
            else:
                raw = data[pos_:pos_ + 6 * n_samp]
                pos_ += 6 * n_samp
            probs = np.frombuffer(raw, "<u2").reshape(n_samp, 3) / 32768.0
            dose_ref = 2 * probs[:, 0] + probs[:, 1]  # count of first allele
            miss = probs.sum(axis=1) == 0
            d = 2.0 - dose_ref                        # ALT dosage
            d[miss] = np.nan
        else:
            (blk_len,) = struct.unpack_from("<I", data, pos_)
            pos_ += 4
            end = pos_ + blk_len
            if compression == 1:
                (dlen,) = struct.unpack_from("<I", data, pos_)
                raw = zlib.decompress(data[pos_ + 4:end])
                assert len(raw) == dlen
            elif compression == 2:
                (dlen,) = struct.unpack_from("<I", data, pos_)
                import zstandard as _zstd
                raw = _zstd.ZstdDecompressor().decompress(
                    data[pos_ + 4:end], max_output_size=dlen)
                assert len(raw) == dlen
            else:
                raw = data[pos_:end]
            pos_ = end
            (ns, na) = struct.unpack_from("<IH", raw, 0)
            min_pl, max_pl = raw[6], raw[7]
            ploidy = np.frombuffer(raw[8:8 + ns], np.uint8)
            missing_mask = (ploidy & 0x80) != 0
            phased = raw[8 + ns]
            nbits = raw[9 + ns]
            body = raw[10 + ns:]
            if min_pl != 2 or max_pl != 2:
                raise NotImplementedError("only diploid BGEN supported")
            # diploid biallelic: 2 stored values per sample — unphased:
            # (p11, p12) genotype probs; phased: per-haplotype P(allele 1)
            if nbits in (8, 16, 32):
                dt = {8: np.uint8, 16: "<u2", 32: "<u4"}[nbits]
                vals = np.frombuffer(body, dt).astype(np.float64)
                vals = vals.reshape(ns, 2) / (2.0 ** nbits - 1)
            else:
                bits = np.unpackbits(np.frombuffer(body, np.uint8),
                                     bitorder="little")
                need = ns * 2 * nbits
                bits = bits[:need].reshape(ns * 2, nbits)
                weights = (2.0 ** np.arange(nbits))
                vals = (bits * weights).sum(axis=1).reshape(ns, 2) / (2.0 ** nbits - 1)
            if phased:
                # E[count of first allele] = sum of per-haplotype P(allele 1)
                dose_ref = vals[:, 0] + vals[:, 1]
            else:
                p_aa = vals[:, 0]      # hom first-allele (REF REF)
                p_ab = vals[:, 1]
                dose_ref = 2 * p_aa + p_ab
            d = 2.0 - dose_ref
            d[missing_mask] = np.nan
        G[:, v] = d
        chrs.append(chrom)
        posns.append(vpos)
        vids.append(rsid)
        refs.append(alleles[0])
        alts.append(alleles[1])
    return (G, sample_ids, np.array(chrs), np.array(posns), np.array(vids),
            np.array(refs), np.array(alts))
