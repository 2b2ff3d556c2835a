// Value score A = V'R over the transposed per-SNP words through int8 digit
// planes of R, on the int8 tensor cores of Hopper (sm_90a).
//
// Replaces tools/kernel_lab5.py::_kernel_T (driven there by xt_dots_T, the
// round-4 lab prototype of the transposed layout).  Same contract:
//
//   words_t (nw, p_all) words, read as uint32: word (w, j) holds bytes
//           4w..4w+3 of SNP j's crumb-transposed row, so crumb q of its byte
//           b is sample q*n4 + 4w + b (n4 = 4*nw)
//   digits  (chunks * 8*NT, n_pad = 4*n4) int8: the digit planes of R
//           (ops/decode.py::quantize_rhs_planes, |digit| <= 64), regrouped by
//           the wrapper into chunks of nc = 8*NT/3 columns: row d*nc + c of a
//           chunk is digit d (hi, mid, lo) of its column c, the rest zero
//   scale   (m,) f32 per-column scale of the digits
//   out     A (m, p_all) f32, row-major:
//           A = (16384*a_hi + 128*a_mid + a_lo) * scale in that f32 order,
//           a_* the exact int32 sums of decoded values times digits
//
// Decode per 32-bit word, 16 crumbs at once: h = (t >> 1) & 0x55555555,
// v = h + (h & t) gives every crumb's value in {0,1,2} (missing -> 0), and
// (v >> 2q) & 0x03030303 is crumb plane q as four int8 values: samples
// q*n4 + 4w .. 4w+3 of one SNP, i.e. four consecutive K values of one MMA row.
//
// What bounds it on an H100: 3 digit planes x 2*n_pad*p*m int8 operations
// (6.1e12 at 10k x 1M, m = 100: 3.1 ms at the 1,979 TOP/s data sheet) against
// reading the 2.56 GB of words (0.76 ms at 3.35 TB/s); at m <= 8 the bytes
// bound it.  The integer sums are exact while 128 * n_pad < 2^31 (the wrapper
// checks), so the kernel equals its plain version bit for bit.
//
// Design: mma.sync.m16n8k32 s8 x s8 -> s32 with SNPs as the MMA's M, the
// chunk's 8*NT digit rows as N and the samples of one crumb plane as K.  The
// layout hands over the A fragments: for a K step of 32 samples thread
// (group g, lane t) needs words k0/4 + t and k0/4 + 4 + t of SNPs g and g+8,
// and the same 8 words per SNP serve all four crumb planes, each with its
// own shift, so every word is read once per block and decoded once.  A block
// owns 128 SNPs and one chunk of digit rows (the tiling, the B staging and
// the exact combine are i8_mma.cuh's, shared with kernel_probe.cu);
// consecutive blocks take the chunks of the same SNPs, so the words of a
// chunk after the first come from L2.  No atomics: results repeat.  wgmma,
// TMA and a pipelined ring are later work.

#include "i8_mma.cuh"

namespace {

using namespace i8mma;

template <int NT>
__global__ void __launch_bounds__(kThreads)
xt_dots_i8_kernel(const uint32_t* __restrict__ words_t,
                  const int8_t* __restrict__ digits,
                  const float* __restrict__ scale, float* __restrict__ out,
                  int nw, int p_all, int m, int chunks) {
  constexpr int kRows = Shared<NT>::kRows;
  constexpr int kNc = kRows / 3;                // columns per chunk
  __shared__ __align__(16) unsigned char smem[Shared<NT>::kBytes];

  const int chunk = blockIdx.x % chunks;
  const long long snp0 = static_cast<long long>(blockIdx.x / chunks) * kSnps;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const size_t n4 = 4 * static_cast<size_t>(nw);
  const size_t n_pad = 4 * n4;
  const int8_t* dchunk = digits + static_cast<size_t>(chunk) * kRows * n_pad;

  // this thread's SNP columns: rows g and g+8 of each of its warp's tiles
  long long col[kMt][2];
  bool ok[kMt][2];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      col[mt][h] = snp0 + (warp * kMt + mt) * 16 + g + 8 * h;
      ok[mt][h] = col[mt][h] < p_all;
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
    // behind it: K step s takes words w0+8s+t (a0, a1) and w0+8s+4+t (a2, a3)
    uint32_t wv[kSteps][kMt][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int w = w0 + 8 * s + t + 4 * (r >> 1);
          const int h = r & 1;
          wv[s][mt][r] =
              (ok[mt][h] && w < nw)
                  ? __ldg(words_t + static_cast<size_t>(w) * p_all + col[mt][h])
                  : 0u;
        }

    __syncthreads();                           // previous tile consumed
    const int tw = min(kKw, nw - w0);          // a multiple of 4
    for (int i = threadIdx.x; i < 4 * kRows * (kKw / 4); i += kThreads) {
      const int piece = i % (kKw / 4);         // 16 bytes: 4 sample words
      const int row = (i / (kKw / 4)) % kRows;
      const int q = i / ((kKw / 4) * kRows);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (4 * piece < tw)
        v = __ldg(reinterpret_cast<const uint4*>(
            dchunk + row * n_pad + q * n4 + 4 * (w0 + 4 * piece)));
      *reinterpret_cast<uint4*>(smem + (q * kRows + row) * kRowBytes +
                                16 * piece) = v;
    }
    __syncthreads();

#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (w0 + 8 * s >= nw) break;             // uniform over the block
      uint32_t dv[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) dv[mt][r] = recode(wv[s][mt][r]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t a[kMt][4];
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[mt][r] = (dv[mt][r] >> (2 * q)) & 0x03030303u;
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

  const int c0 = chunk * kNc;
  write_scores<NT>(smem, acc, snp0, p_all, c0, min(kNc, m - c0), scale, out,
                   p_all);
}

template <int NT>
int launch(const uint32_t* w, const int8_t* d, const float* s, float* out,
           int nw, int p_all, int m, cudaStream_t stream) {
  const int nc = 8 * NT / 3;
  const int chunks = (m + nc - 1) / nc;
  const long long blocks =
      static_cast<long long>((p_all + kSnps - 1) / kSnps) * chunks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  xt_dots_i8_kernel<NT><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(w, d, s, out, nw, p_all, m, chunks);
  return 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  nt is 1, 4 or 8 (8*nt digit rows
// a chunk, nc = 8*nt/3 columns, as the wrapper laid out `digits`); nw must be
// a multiple of 4 and every pointer 16-byte aligned (the wrapper checks).
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// so a refused launch is seen by the caller.
extern "C" int xt_dots_T(const void* words_t, const void* digits,
                         const void* scale, void* out, int nw, int p_all,
                         int m, int nt, void* stream) {
  if (p_all > 0 && m > 0 && nw > 0) {
    const auto* w = static_cast<const uint32_t*>(words_t);
    const auto* d = static_cast<const int8_t*>(digits);
    const auto* s = static_cast<const float*>(scale);
    auto* o = static_cast<float*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    int err = 0;
    if (nt == 1)
      err = launch<1>(w, d, s, o, nw, p_all, m, st);
    else if (nt == 4)
      err = launch<4>(w, d, s, o, nw, p_all, m, st);
    else if (nt == 8)
      err = launch<8>(w, d, s, o, nw, p_all, m, st);
    else
      err = static_cast<int>(cudaErrorInvalidValue);
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}
