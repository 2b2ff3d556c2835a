// Fused 2-bit genotype decode + multi-RHS score X'R for Hopper (sm_90a).
//
// Replaces mendeliht_tpu/ops/pallas_kernels.py::_kernel (driven there by
// _xt_dots_chunk / xt_dots_words).  Same contract, own design:
//
//   words (p4, n4) quad words, read as uint32: byte k of words[i, w] is byte
//         w of SNP 4i+k, and crumb q of that byte is sample q*n4 + w
//   rhs   (m, n_pad = 4*n4) f32, row-major (one RHS column per row)
//   out   A = V'R, M = Miss'R (optional), S = V^2'R (optional),
//         each (m, 4*p4) f32, row-major
//
// Decode per 32-bit word, all 16 crumbs at once (decode algebra of
// mendeliht_tpu/ops/decode.py):  h = (t >> 1) & 0x55555555 is the hi bit of
// every crumb, v = h + (h & t) value-codes every crumb into {0,1,2},
// miss = lo & ~hi, and V^2 = 3V - 2H with H the hi-bit dot.
//
// Numerics: plain f32 FMAs on the CUDA cores, no quantization of R (the TPU
// kernel splits R into three int8 digit planes for its int8 MXU).  Zero
// crumbs are multiplied like any other, so a NaN in an R column poisons that
// column's outputs exactly as the f32 reference does.
//
// What bounds it on an H100: at m ~ 1 (one fit) the pass is a GEMV over
// 2-bit data, about 4 FMAs per byte read, so it is bound by the bytes of
// the words (2.56 GB at 10k x 1M) and by the integer work of the decode.
// The decode is therefore done once per word for all RHS columns of a chunk:
// one shift+mask per crumb plane extracts the four SNPs' crumbs, a byte
// permute against the exponent of 2^23 turns each crumb into a float in two
// instructions (no integer-to-float conversion unit), and each decoded value
// feeds MC FMAs.  At large m the pass is bound by f32 FMAs (p*n*m of them
// per output); the MC = 8 column chunk keeps 8 accumulators per SNP per
// output in registers and stages R tiles in shared memory, so each R value
// read from shared memory serves the four SNPs of a word.  A tensor-core
// route for large m is later work.
//
// Design: one warp per quad row (4 SNPs), 8 warps per block.  Lanes stride
// the row's n4 words (coalesced 128-byte loads).  The block stages an R tile
// of MC columns x 4 crumb planes x TILE words in shared memory, shared by
// its 8 rows.  Each lane keeps f32 accumulators for 4 SNPs x MC columns x
// up to 3 outputs; a warp-shuffle reduction at the end of each column chunk
// gives the row's sums.  No atomics: results repeat run to run.  Padding is
// inert: samples past n are code 0 with R = 0 there, and SNPs past p are zero
// bytes that the caller slices off.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // quad rows (warps) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 256;           // words of a row per shared R tile

// 0x4B000000 is 2^23 as a float; its low mantissa byte replaced by a crumb
// x in {0..3} is 2^23 + x exactly, so subtracting 2^23 gives float(x).
__device__ __forceinline__ float crumb_byte(uint32_t planes, int k) {
  return __uint_as_float(__byte_perm(planes, 0x4B000000u, 0x7540u + k)) -
         8388608.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int MC, bool MISS, bool SQ>
__global__ void __launch_bounds__(kThreads)
xt_dots_kernel(const uint32_t* __restrict__ words,
               const float* __restrict__ rhs, float* __restrict__ A,
               float* __restrict__ M, float* __restrict__ S, int p4, int n4,
               int m) {
  __shared__ float tile[MC * 4 * kTile];     // [column][plane][word]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  const bool row_ok = row < p4;
  const uint32_t* wrow = words + static_cast<size_t>(row_ok ? row : 0) * n4;
  const size_t n_pad = 4 * static_cast<size_t>(n4);
  const size_t p_out = 4 * static_cast<size_t>(p4);

  for (int c0 = 0; c0 < m; c0 += MC) {
    const int nc = min(MC, m - c0);
    float acc_a[4][MC];
    float acc_m[4][MC];
    float acc_h[4][MC];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < MC; ++c) {
        acc_a[k][c] = 0.f;
        acc_m[k][c] = 0.f;
        acc_h[k][c] = 0.f;
      }

    for (int t0 = 0; t0 < n4; t0 += kTile) {
      const int tl = min(kTile, n4 - t0);
      __syncthreads();                       // previous tile fully consumed
      for (int i = threadIdx.x; i < MC * 4 * kTile; i += kThreads) {
        const int j = i % kTile;
        const int q = (i / kTile) % 4;
        const int c = i / (4 * kTile);
        float r = 0.f;
        if (c < nc && j < tl)
          r = rhs[static_cast<size_t>(c0 + c) * n_pad +
                  static_cast<size_t>(q) * n4 + t0 + j];
        tile[i] = r;
      }
      __syncthreads();
      if (!row_ok) continue;

#pragma unroll 4
      for (int j = lane; j < tl; j += 32) {
        const uint32_t t = __ldg(wrow + t0 + j);
        const uint32_t h = (t >> 1) & 0x55555555u;
        const uint32_t v = h + (h & t);
        const uint32_t lo = t & 0x55555555u;
        const uint32_t miss = lo & ~h;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float r[MC];
#pragma unroll
          for (int c = 0; c < MC; ++c) r[c] = tile[(c * 4 + q) * kTile + j];
          const uint32_t vq = (v >> (2 * q)) & 0x03030303u;
          const uint32_t mq = (miss >> (2 * q)) & 0x01010101u;
          const uint32_t hq = (h >> (2 * q)) & 0x01010101u;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float fv = crumb_byte(vq, k);
#pragma unroll
            for (int c = 0; c < MC; ++c)
              acc_a[k][c] = fmaf(fv, r[c], acc_a[k][c]);
            if (MISS) {
              const float fm = crumb_byte(mq, k);
#pragma unroll
              for (int c = 0; c < MC; ++c)
                acc_m[k][c] = fmaf(fm, r[c], acc_m[k][c]);
            }
            if (SQ) {
              const float fh = crumb_byte(hq, k);
#pragma unroll
              for (int c = 0; c < MC; ++c)
                acc_h[k][c] = fmaf(fh, r[c], acc_h[k][c]);
            }
          }
        }
      }
    }

    if (!row_ok) continue;                   // uniform per warp
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int c = 0; c < MC; ++c) {
        const float a = warp_sum(acc_a[k][c]);
        const float mm = MISS ? warp_sum(acc_m[k][c]) : 0.f;
        const float hh = SQ ? warp_sum(acc_h[k][c]) : 0.f;
        if (lane == 0 && c < nc) {
          const size_t o = static_cast<size_t>(c0 + c) * p_out + 4 * row + k;
          A[o] = a;
          if (MISS) M[o] = mm;
          if (SQ) S[o] = 3.f * a - 2.f * hh;
        }
      }
  }
}

template <int MC>
void launch(const uint32_t* words, const float* rhs, float* A, float* M,
            float* S, int p4, int n4, int m, bool miss, bool sq,
            cudaStream_t stream) {
  const dim3 grid((p4 + kWarps - 1) / kWarps);
  if (miss && sq)
    xt_dots_kernel<MC, true, true><<<grid, kThreads, 0, stream>>>(
        words, rhs, A, M, S, p4, n4, m);
  else if (miss)
    xt_dots_kernel<MC, true, false><<<grid, kThreads, 0, stream>>>(
        words, rhs, A, M, S, p4, n4, m);
  else if (sq)
    xt_dots_kernel<MC, false, true><<<grid, kThreads, 0, stream>>>(
        words, rhs, A, M, S, p4, n4, m);
  else
    xt_dots_kernel<MC, false, false><<<grid, kThreads, 0, stream>>>(
        words, rhs, A, M, S, p4, n4, m);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  M / S may be null when not
// wanted.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so a refused launch is seen by the caller.
extern "C" int xt_dots_words(const void* words, const void* rhs, void* A,
                             void* M, void* S, int p4, int n4, int m,
                             int want_missing, int want_sq, void* stream) {
  if (p4 > 0 && m > 0) {
    const auto* w = static_cast<const uint32_t*>(words);
    const auto* r = static_cast<const float*>(rhs);
    auto* a = static_cast<float*>(A);
    auto* mm = static_cast<float*>(M);
    auto* s = static_cast<float*>(S);
    auto st = static_cast<cudaStream_t>(stream);
    if (m == 1)
      launch<1>(w, r, a, mm, s, p4, n4, m, want_missing, want_sq, st);
    else
      launch<8>(w, r, a, mm, s, p4, n4, m, want_missing, want_sq, st);
  }
  return static_cast<int>(cudaGetLastError());
}
