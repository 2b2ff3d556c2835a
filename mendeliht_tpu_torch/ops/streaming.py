"""Out-of-core genotypes: the packed words stay in host memory and every
full-width pass streams SNP blocks through the card (the JAX package's
``ops/streaming.py``).

The reference mmaps its ``.bed`` files, so its working set is 2np bits of
virtual memory, and UK-Biobank-scale problems run on any node with the
RAM (500k x 1M is 125 GB packed, past one card's 80 GB).  Here the
operator keeps a resident prefix of the quad rows on the card (up to
``resident_bytes``, default ``MENDELIHT_STREAM_RESIDENT_BYTES`` or 10 GiB)
and streams the rest in blocks of ``block_p`` SNPs on each pass:

- the host words are page-locked in place (``cudaHostRegister`` on the
  numpy buffer; a copy through ``Tensor.pin_memory`` would double host
  RAM at biobank size), and a failed registration raises.  The
  registration and the resident prefix belong to the genotypes: the first
  operator over them makes both, every later one (each ``fit_iht`` /
  ``cv_iht`` call builds its own) reuses them, and they go when the
  genotypes go;
- a side stream copies block i + 1 into one of two preallocated device
  buffers while kernel 1 (``kernels.xt_dots_words``) reads block i from
  the other; CUDA events order the two streams (a copy into a buffer waits
  for the kernel that last read it, a kernel for its copy), so memory is
  bounded by construction and the host never waits inside a pass;
- the RHS is quantised once a pass (``kernels.score_image``) and each
  block and the prefix run kernel 1 on that image: the per-column scale
  depends on R alone, so every block's columns equal the whole-matrix
  launch's bit for bit, and so does every pass of the streamed operator;
- a forward product gathers its S quad rows from the host words: one
  fetch of the indices to the host (``syncs`` counts them), the distinct
  rows uploaded once.

On the CPU the blocks are views of the host words and take the
unquantised ``decode.xt_dots`` in R's dtype, as ``PackedOp`` does there;
nothing is copied.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from . import decode, kernels
from .linalg import PackedOp, _env_int
from ..genotype.snparray import (_LANE, PackedGenotypes, _ceil_to, bed_stats,
                                 repacked_bed_chunks)
from ..utils.device import float_dtype, resolve_device

# the JAX package's defaults, sized for a v5e's ~14.5 GiB of usable HBM
_RESIDENT_DEFAULT = 10 * 2**30
_BLOCK_DEFAULT = 1 << 30
_HOST_REGISTER_PORTABLE = 1          # cudaHostRegisterPortable


def _resident_budget() -> int:
    """Device bytes of the resident prefix: ``MENDELIHT_STREAM_RESIDENT_
    BYTES`` (0 streams everything), default ``_RESIDENT_DEFAULT``; a
    malformed value raises."""
    return _env_int("MENDELIHT_STREAM_RESIDENT_BYTES", _RESIDENT_DEFAULT)


# page-locked host buffers by address: how many genotypes hold each
_REGISTERED: dict[int, int] = {}


def _register(words: np.ndarray):
    ptr = words.ctypes.data
    if not _REGISTERED.get(ptr):
        err = int(torch.cuda.cudart().cudaHostRegister(
            ptr, words.nbytes, _HOST_REGISTER_PORTABLE))
        if err:
            raise RuntimeError(f"cudaHostRegister of the host words "
                               f"({words.nbytes} bytes) failed: CUDA error "
                               f"{err}")
    _REGISTERED[ptr] = _REGISTERED.get(ptr, 0) + 1


def _release(words: np.ndarray):
    """Drop one hold on ``words``' registration; the last unregisters (the
    array is an argument, so it outlives its registration)."""
    ptr = words.ctypes.data
    _REGISTERED[ptr] -= 1
    if not _REGISTERED[ptr]:
        del _REGISTERED[ptr]
        torch.cuda.cudart().cudaHostUnregister(ptr)


def is_registered(words: np.ndarray) -> bool:
    """Whether an operator holds ``words`` page-locked."""
    return bool(_REGISTERED.get(words.ctypes.data))


@dataclasses.dataclass
class HostStreamedGenotypes:
    """2-bit packed genotypes whose quad words lie in host memory; the
    per-SNP ``mu`` / ``inv_sd`` lie on the device the operator runs on.
    The storage and statistics of :class:`PackedGenotypes`.

    ``block_bytes`` of packed words are streamed a block (``block_p``
    SNPs), and up to ``resident_bytes`` of the leading quad rows stay on
    the device (None: ``MENDELIHT_STREAM_RESIDENT_BYTES``, default 10 GiB;
    0 streams everything).  The page lock of ``words`` and the resident
    prefix (:meth:`resident_words`) last as long as these genotypes.
    The host words are the field ``words_np``, the JAX package's name;
    ``words`` reads the same array."""

    words_np: np.ndarray          # (ceil(p/4), n4) int32 quad words, host
    mu: torch.Tensor              # (p,) on the device
    inv_sd: torch.Tensor          # (p,) on the device
    n: int
    p: int
    has_missing: bool
    block_bytes: int = _BLOCK_DEFAULT
    resident_bytes: int | None = None
    # the registration and the prefix, made by the first operator
    _held: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def words(self) -> np.ndarray:
        """The host quad words (``words_np``)."""
        return self.words_np

    @property
    def shape(self):
        return (self.n, self.p)

    @property
    def n_pad(self) -> int:
        return 4 * self.words.shape[1]

    @property
    def block_p(self) -> int:
        """SNPs a streamed block (a multiple of 4: whole quad rows)."""
        return 4 * max(1, int(self.block_bytes) // (self.words.shape[1] * 4))

    @property
    def device(self) -> torch.device:
        return self.mu.device

    @property
    def dtype(self) -> torch.dtype:
        return self.mu.dtype

    def __repr__(self):
        return (f"HostStreamedGenotypes(n={self.n}, p={self.p}, "
                f"words={self.words.shape} int32 host, "
                f"block_p={self.block_p}, has_missing={self.has_missing}, "
                f"device={self.device})")

    def resident_words(self, res_q: int) -> torch.Tensor | None:
        """The leading ``res_q`` quad rows on the device (None for 0),
        uploaded once and reused while ``res_q`` stays the same; on the card
        the host words are page-locked first, until these genotypes are
        freed."""
        held = self._held
        if self.device.type == "cuda" and not held.get("registered"):
            _register(self.words)
            weakref.finalize(self, _release, self.words)
            held["registered"] = True
        if held.get("res_q") != res_q:
            held.pop("prefix", None)
            held["prefix"] = (torch.from_numpy(self.words[:res_q])
                              .to(self.device) if res_q else None)
            held["res_q"] = res_q
        return held["prefix"]

    @classmethod
    def from_snparray(cls, geno: PackedGenotypes,
                      block_bytes: int = _BLOCK_DEFAULT,
                      resident_bytes: int | None = None
                      ) -> "HostStreamedGenotypes":
        """Genotypes' words moved to host memory (a view where they lie
        on the CPU); mu and 1/sd stay on their device."""
        return cls(words_np=np.ascontiguousarray(geno.words.cpu().numpy()),
                   mu=geno.mu, inv_sd=geno.inv_sd, n=geno.n, p=geno.p,
                   has_missing=geno.has_missing, block_bytes=block_bytes,
                   resident_bytes=resident_bytes)

    @classmethod
    def from_plink(cls, prefix: str, dtype=torch.float32,
                   block_bytes: int = _BLOCK_DEFAULT,
                   resident_bytes: int | None = None,
                   device=None) -> "HostStreamedGenotypes":
        """Read ``prefix.bed`` (n from ``.fam``, p from ``.bim``) into host
        words: the payload is repacked on ``device`` (default the card; it
        raises where there is none and ``device`` is not "cpu") a chunk of
        SNPs at a time, and each chunk's words come back to one host
        array, so the packed matrix is never on the device whole.  mu and
        1/sd are in ``dtype``, float32 or float64."""
        from ..genotype.plink import _bed_payload
        dtype = float_dtype(dtype, "HostStreamedGenotypes.from_plink")
        device = resolve_device(device)
        bed, n, p = _bed_payload(prefix)
        words = np.zeros((-(-p // 4), _ceil_to(-(-n // 4), _LANE)), np.int32)
        counts = np.zeros((3, p), np.int64)
        for lo, hi, w, c in repacked_bed_chunks(bed, n, p, device):
            words[lo // 4:lo // 4 + w.shape[0]] = w.cpu().numpy()
            counts[:, lo:hi] = c.cpu().numpy()
        stats = bed_stats(counts, n, dtype, device)
        return cls(words_np=words, mu=stats["mu"], inv_sd=stats["inv_sd"],
                   n=n, p=p, has_missing=stats["has_missing"],
                   block_bytes=block_bytes, resident_bytes=resident_bytes)


class StreamedPackedOp(PackedOp):
    """The PackedOp contract (``xtr``, ``col_moments``, ``forward_sel``,
    ``forward_sel_multi``, ``gather_cols``) over HostStreamedGenotypes,
    on their device.

    ``dtype`` is the operator's, as :class:`PackedOp`'s; a float64 pass
    runs kernel 1's float64 entry on each block against one float64 digit
    image.  ``prefix`` holds the resident quad rows as PackedGenotypes
    without the transposed layout; ``p_res`` is its SNPs.  ``syncs``
    counts the host fetches of the forward products' indices, ``copies``
    the blocks copied to the card."""

    def __init__(self, geno: HostStreamedGenotypes,
                 dtype: torch.dtype | None = None):
        super().__init__(geno, dtype)
        budget = (geno.resident_bytes if geno.resident_bytes is not None
                  else _resident_budget())
        p4, n4 = geno.words.shape
        res_q = max(0, min(p4, int(budget) // (n4 * 4)))
        self.p_res = min(4 * res_q, geno.p)
        self.syncs = self.copies = 0
        self._host = torch.from_numpy(geno.words)          # a view
        dev = geno.device
        words = geno.resident_words(res_q)
        self.prefix = None
        if res_q:
            self.prefix = PackedGenotypes(
                words=words, mu=geno.mu[:self.p_res],
                inv_sd=geno.inv_sd[:self.p_res], n=geno.n, p=self.p_res,
                has_missing=geno.has_missing)
        rows = min(geno.block_p // 4, p4 - res_q)
        if dev.type == "cuda" and rows > 0:
            self._stream = torch.cuda.Stream(dev)
            self._bufs = [torch.empty((rows, n4), dtype=torch.int32,
                                      device=dev) for _ in range(2)]
            for buf in self._bufs:
                buf.record_stream(self._stream)
            self._copied = [torch.cuda.Event() for _ in range(2)]
            self._read = [torch.cuda.Event() for _ in range(2)]

    def _blocks(self):
        """The streamed SNP ranges [lo, hi): everything past the prefix."""
        bp = self.geno.block_p
        return [(lo, min(lo + bp, self.p))
                for lo in range(self.p_res, self.p, bp)]

    def _xt_dots(self, RT: torch.Tensor, want_sq: bool = False):
        """Raw dots (A, M, S) of the whole matrix against RT (n_pad, m), as
        ``PackedOp._xt_dots`` returns them: on the CPU the unquantised
        function on views of the host words, on the card kernel 1 on the
        prefix and on each streamed block against one image of RT."""
        kw = dict(want_missing=self.geno.has_missing, want_sq=want_sq)
        if RT.device.type != "cpu":
            return self._xt_dots_card(RT, kw)
        ranges = ([(0, self.p_res)] if self.p_res else []) + self._blocks()
        parts = [decode.xt_dots(self._host[lo // 4:-(-hi // 4)], RT,
                                p=hi - lo, **kw) for lo, hi in ranges]
        return tuple(None if parts[0][i] is None
                     else torch.cat([pt[i] for pt in parts])
                     for i in range(3))

    def _xt_dots_card(self, RT: torch.Tensor, kw: dict):
        """``_xt_dots`` on the card: one digit image of RT, kernel 1 on the
        prefix and on each streamed block, the blocks' outputs joined."""
        image = kernels.score_image(RT, **kw)
        parts = []
        if self.prefix is not None:
            parts.append(kernels.xt_dots_words_image(self.prefix.words,
                                                     image, p=self.p_res))
        parts.extend(self._stream_blocks(image))
        # (m, p) in memory, as one launch's (p, m) views lie
        return tuple(None if parts[0][i] is None
                     else torch.cat([pt[i].t() for pt in parts], dim=1).t()
                     for i in range(3))

    def _copy(self, b: int, blocks):
        """Queue the copy of block b's quad rows into buffer b % 2 on the
        side stream, after the kernel that last read that buffer."""
        lo, hi = blocks[b]
        q0, q1 = lo // 4, -(-hi // 4)
        i = b % 2
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(self._read[i])
            self._bufs[i][:q1 - q0].copy_(self._host[q0:q1], non_blocking=True)
            self._copied[i].record(self._stream)
        self.copies += 1

    def _stream_blocks(self, image):
        """Kernel 1 on each streamed block, its copy overlapping the
        previous block's kernel; returns each block's (A, M, S)."""
        blocks = self._blocks()
        if not blocks:
            return []
        cur = torch.cuda.current_stream(self.device)
        outs = []
        self._copy(0, blocks)
        for b, (lo, hi) in enumerate(blocks):
            if b + 1 < len(blocks):
                self._copy(b + 1, blocks)
            i = b % 2
            cur.wait_event(self._copied[i])
            rows = -(-hi // 4) - lo // 4
            outs.append(kernels.xt_dots_words_image(self._bufs[i][:rows],
                                                    image, p=hi - lo))
            self._read[i].record(cur)
        return outs

    def _rows_bytes(self, idx: torch.Tensor) -> torch.Tensor:
        """The byte rows (B, S, n4) uint8 of the SNPs idx (B, S), gathered
        from the host words: on the card one fetch of idx (counted in
        ``syncs``) and one upload of the distinct quad rows."""
        if idx.device.type == "cpu":
            return decode.take_rows_bytes(self._host, idx)
        B, S = idx.shape
        flat = idx.reshape(-1).long()
        quads, inv = np.unique((flat // 4).cpu().numpy(),
                               return_inverse=True)
        self.syncs += 1
        # a pageable upload returns once its source is staged: no sync
        up = dict(device=self.device, non_blocking=True)
        rows = torch.from_numpy(self.geno.words[quads]).to(**up)
        g = rows[torch.from_numpy(inv.reshape(-1)).to(**up)]
        shift = ((flat % 4) * 8).to(torch.int32)[:, None]
        return ((g >> shift) & 0xFF).to(torch.uint8).reshape(B, S, -1)
