// The round-3 kernel probe's three kernels on Hopper (sm_90a).
//
// Replaces the three pallas_calls of tools/kernel_probe.py:
//
// 1. xt_i8_rounds (body _kernel_i8_rounds): the value score A = V'R over the
//    retired row-major layout through int8 digit planes of R.
//      words   (p, nw) words, read as uint32: crumb s of byte b of word
//              (j, w) is sample s*n4 + 4w + b of SNP j (n4 = 4*nw), the
//              transpose of the layout xt_dots_i8.cu reads
//      digits  (chunks * 8*NT, n_pad = 4*n4) int8, the digit rows of R in
//              xt_dots_i8.cu's chunked order (ops/kernels.py::_digit_chunks)
//      scale   (m,) f32;  out  A (m, p) f32, row-major,
//              (16384*a_hi + 128*a_mid + a_lo) * scale in that f32 order
//    The TPU kernel decodes one crumb of each word per round (16 rounds) and
//    contracts it with that round's digit plane on the MXU.  Here the rounds
//    are the MMA's K order: mma.sync.m16n8k32 s8 x s8 -> s32, SNPs as M,
//    digit rows as N.  One decoded word (v = h + (h & t), h = (t >> 1) &
//    0x55555555) gives, as (v >> 2s) & 0x03030303, four consecutive samples
//    of crumb plane s: four K values of one A row.  So the rounds of a word
//    are four crumb planes times its four bytes, and each word is read once
//    and decoded once per block.
//    Words are read as 16-byte loads along each SNP row (thread t of a row
//    takes words 4t..4t+3 and 16+4t..16+4t+3 of a 32-word tile), which hands
//    a thread K values in another order than the MMA's fragment wants.  The
//    sum over K does not care about the order as long as B follows the same
//    one, so B is staged into shared memory in that permuted order: MMA slot
//    j (kernel xt_dots_i8.cu's word 8s + t or 8s + 4 + t of the tile) holds
//    the digits of tile word 4(j & 3) + 16(j >> 4) + ((j >> 2) & 3).
//    A block of 4 warps takes tp SNP rows (the reference's tp) in sub-tiles
//    of 128 and one chunk of digit rows; otherwise it is xt_dots_i8.cu's
//    design (the tiling and exact integer combine of i8_mma.cuh), so both
//    equal their plain versions and each other bit for bit.
//    Bound on an H100: reading the words (0.77 ms at 10k x 1M) at m <= 8, the
//    int8 operations (3 digit planes x 2*n_pad*p*m) beyond.
//
// 2. stream_xor (body _kernel_stream): out (tp, nw) int32, row r the XOR of
//    words[i*tp + r] + seed over the row tiles i.
// 3. decode_only (body _kernel_decode_only): out (tp, tw) int32, the XOR over
//    every (tp, tw) tile of the 16-crumb value sum of words + seed, in the
//    reference's round order.
//    On the TPU the grid runs in order and each step XORs its tile into one
//    resident output block.  Here each thread owns one output element and
//    loops over the tiles itself, eight independent loads in flight, with
//    neighbouring threads on neighbouring words: no atomics, and the result
//    does not depend on scheduling.  Rows and word columns past the array
//    are absent (they contribute nothing); the reference leaves a ragged
//    last tile undefined.  All arithmetic is uint32, so words + seed wraps as
//    in the reference's int32.  Bound: the words' bytes for both.  The
//    decode's function needs ~8 integer operations a word (popc(h) +
//    popc(h & t) of the recode's h), well under the bytes; this kernel does
//    the reference's 16 x (shift, and, add) instead, so it runs above its
//    bound.

#include "i8_mma.cuh"

namespace {

using namespace i8mma;

// ------------------------------------------------------------- kernel 7
template <int NT>
__global__ void __launch_bounds__(kThreads)
xt_i8_rounds_kernel(const uint32_t* __restrict__ words,
                    const int8_t* __restrict__ digits,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int p, int nw, int m, int chunks, int tp) {
  constexpr int kRows = Shared<NT>::kRows;
  constexpr int kNc = kRows / 3;                // columns per chunk
  __shared__ __align__(16) unsigned char smem[Shared<NT>::kBytes];

  const int chunk = blockIdx.x % chunks;
  const long long row0 = static_cast<long long>(blockIdx.x / chunks) * tp;
  const long long row_end = min(static_cast<long long>(p), row0 + tp);
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const size_t n4 = 4 * static_cast<size_t>(nw);
  const size_t n_pad = 4 * n4;
  const int8_t* dchunk = digits + static_cast<size_t>(chunk) * kRows * n_pad;
  const int c0 = chunk * kNc;
  const int ncols = min(kNc, m - c0);

  for (long long snp0 = row0; snp0 < row_end; snp0 += kSnps) {
    // this thread's SNP rows: g and g+8 of each of its warp's tiles
    long long row[kMt][2];
    bool ok[kMt][2];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row[mt][h] = snp0 + (warp * kMt + mt) * 16 + g + 8 * h;
        ok[mt][h] = row[mt][h] < row_end;
      }

    int acc[kMt][NT][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

    for (int w0 = 0; w0 < nw; w0 += kKw) {
      // the tile's words, issued before the B staging so their latency hides
      // behind it: wv[mt][h][4u + c] is word w0 + 16u + 4t + c of the row
      uint32_t wv[kMt][2][8];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int w = w0 + 16 * u + 4 * t;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (ok[mt][h] && w < nw)             // nw % 4 == 0
              v = __ldg(reinterpret_cast<const uint4*>(
                  words + static_cast<size_t>(row[mt][h]) * nw + w));
            wv[mt][h][4 * u] = v.x;
            wv[mt][h][4 * u + 1] = v.y;
            wv[mt][h][4 * u + 2] = v.z;
            wv[mt][h][4 * u + 3] = v.w;
          }

      __syncthreads();                           // previous tile consumed
      const int tw = min(kKw, nw - w0);          // a multiple of 4
      // 16-byte piece a (tile words 4a..4a+3) of digit row `row`, plane q,
      // goes to MMA slots (a & 3) + 16(a >> 2) + 4c, c = 0..3
      for (int i = threadIdx.x; i < 4 * kRows * (kKw / 4); i += kThreads) {
        const int piece = i % (kKw / 4);
        const int r = (i / (kKw / 4)) % kRows;
        const int q = i / ((kKw / 4) * kRows);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (4 * piece < tw)
          v = __ldg(reinterpret_cast<const uint4*>(
              dchunk + r * n_pad + q * n4 + 4 * (w0 + 4 * piece)));
        uint32_t* dst = reinterpret_cast<uint32_t*>(
            smem + (q * kRows + r) * kRowBytes) + (piece & 3) + 16 * (piece >> 2);
        dst[0] = v.x;
        dst[4] = v.y;
        dst[8] = v.z;
        dst[12] = v.w;
      }
      __syncthreads();

#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 8; ++i) wv[mt][h][i] = recode(wv[mt][h][i]);

#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        // slot 8s + t is tile word 16(s >> 1) + 4t + 2(s & 1); slot 8s+4+t
        // the word after it
        const int lo = 4 * (s >> 1) + 2 * (s & 1);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t a[kMt][4];
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt) {
            a[mt][0] = (wv[mt][0][lo] >> (2 * q)) & 0x03030303u;
            a[mt][1] = (wv[mt][1][lo] >> (2 * q)) & 0x03030303u;
            a[mt][2] = (wv[mt][0][lo + 1] >> (2 * q)) & 0x03030303u;
            a[mt][3] = (wv[mt][1][lo + 1] >> (2 * q)) & 0x03030303u;
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const unsigned char* brow =
                smem + (q * kRows + nt * 8 + g) * kRowBytes + 4 * (8 * s + t);
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(brow);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(brow + 16);
#pragma unroll
            for (int mt = 0; mt < kMt; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
          }
        }
      }
    }

    write_scores<NT>(smem, acc, snp0, row_end, c0, ncols, scale, out, p);
    // the next sub-tile's first write to shared memory follows a barrier
  }
}

template <int NT>
int launch_rounds(const uint32_t* w, const int8_t* d, const float* s,
                  float* out, int p, int nw, int m, int tp,
                  cudaStream_t stream) {
  const int nc = 8 * NT / 3;
  const int chunks = (m + nc - 1) / nc;
  const long long blocks =
      static_cast<long long>((p + static_cast<long long>(tp) - 1) / tp) * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  xt_i8_rounds_kernel<NT><<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(w, d, s, out, p, nw, m, chunks, tp);
  return 0;
}

// -------------------------------------------------------- kernels 8, 9
constexpr int kXorThreads = 256;
constexpr int kUnroll = 8;                    // independent loads in flight

__device__ __forceinline__ uint32_t crumb_sum(uint32_t t) {
  const uint32_t v = recode(t);
  uint32_t acc = 0;
#pragma unroll
  for (int r = 0; r < 16; ++r) acc += (v >> (2 * (r % 4) + 8 * (r / 4))) & 3u;
  return acc;
}

template <bool kDecode>
__device__ __forceinline__ uint32_t term(uint32_t w, uint32_t seed) {
  return kDecode ? crumb_sum(w + seed) : w + seed;
}

template <bool kDecode>
__global__ void __launch_bounds__(kXorThreads)
xor_tiles_kernel(const uint32_t* __restrict__ words,
                 const uint32_t* __restrict__ seed, uint32_t* __restrict__ out,
                 long long p, long long nw, int tp, int tw) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kXorThreads + threadIdx.x;
  if (idx >= static_cast<long long>(tp) * tw) return;
  const long long r = idx / tw;
  const long long c = idx % tw;
  const uint32_t s = __ldg(seed);
  uint32_t acc = 0;
  for (long long col = c; col < nw; col += tw) {
    long long row = r;
    for (; row + (kUnroll - 1) * static_cast<long long>(tp) < p;
         row += kUnroll * static_cast<long long>(tp)) {
      uint32_t v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        v[k] = __ldg(words + (row + k * static_cast<long long>(tp)) * nw + col);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) acc ^= term<kDecode>(v[k], s);
    }
    for (; row < p; row += tp)
      acc ^= term<kDecode>(__ldg(words + row * nw + col), s);
  }
  out[idx] = acc;
}

template <bool kDecode>
int launch_xor(const void* words, const void* seed, void* out, long long p,
               long long nw, int tp, int tw, void* stream) {
  const long long blocks =
      (static_cast<long long>(tp) * tw + kXorThreads - 1) / kXorThreads;
  if (tp <= 0 || tw <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  xor_tiles_kernel<kDecode><<<static_cast<unsigned>(blocks), kXorThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(seed),
      static_cast<uint32_t*>(out), p, nw, tp, tw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`, does
// not synchronise, and returns cudaGetLastError() so a refused launch is seen
// by the caller.
//
// xt_i8_rounds: nt is 1, 4 or 8 (8*nt digit rows a chunk, as the wrapper laid
// out `digits`); nw must be a multiple of 4 and every pointer 16-byte
// aligned (the wrapper checks); tp >= 1 SNP rows per block.
extern "C" int xt_i8_rounds(const void* words, const void* digits,
                            const void* scale, void* out, int p, int nw,
                            int m, int nt, int tp, void* stream) {
  if (tp <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p > 0 && m > 0 && nw > 0) {
    const auto* w = static_cast<const uint32_t*>(words);
    const auto* d = static_cast<const int8_t*>(digits);
    const auto* s = static_cast<const float*>(scale);
    auto* o = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    int err = 0;
    if (nt == 1)
      err = launch_rounds<1>(w, d, s, o, p, nw, m, tp, st);
    else if (nt == 4)
      err = launch_rounds<4>(w, d, s, o, p, nw, m, tp, st);
    else if (nt == 8)
      err = launch_rounds<8>(w, d, s, o, p, nw, m, tp, st);
    else
      err = static_cast<int>(cudaErrorInvalidValue);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

// xor_tiles: words (p, nw), seed a (1, 1) int32 on the card, out (tp, tw);
// decode 0 is stream_xor (tw = nw), 1 decode_only.
extern "C" int xor_tiles(const void* words, const void* seed, void* out,
                         long long p, long long nw, int tp, int tw,
                         int decode, void* stream) {
  return decode ? launch_xor<true>(words, seed, out, p, nw, tp, tw, stream)
                : launch_xor<false>(words, seed, out, p, nw, tp, tw, stream);
}
