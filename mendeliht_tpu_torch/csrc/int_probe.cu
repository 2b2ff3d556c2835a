// Narrow-integer probes of the tensor cores for Hopper (sm_90a): unpacking
// int32 words into int8 / int4 fields, and a dot with one packed operand.
//
// Replaces tools/kernel_lab5.py::probe_int4 (the bodies k_bitcast,
// k_dot_i4_i8, k_dot_i4_i4 and k_dot_i8_weights_i4, each run by try_one) and
// tools/kernel_lab5.py::bench_int4_ingestion (mk's kern), which asked whether
// the TPU's matrix unit takes int4 operands and whether int4 halves what it
// costs to feed it.
//
//   unpack_words    x (r, c) int32 -> (32/bits * r, c) int32: field j of row
//                   i (low field first, sign-extended) is output row
//                   32/bits * i + j, the word-major order of pltpu.bitcast
//   int_dot_packed  lhs_packed: unpack(x) (M, K) . y (K, N), with y given
//                   transposed as (N, K) int8;  else y (M, K) int8 .
//                   unpack(x) (K, N);  exact int32 (M, N), K % 32 == 0
//
// Hopper facts that shape it: no Hopper MMA multiplies int4 by int8, wgmma
// takes no int4 at all, and mma.sync takes .s4 only against .s4 (m16n8k64).
// So the packed fields are widened to int8 in registers, four to a 32-bit
// fragment register, and every product runs on mma.sync.m16n8k32 s8 x s8.
//
// What bounds it on an H100: the lab's ingestion shape (M, K, N) =
// (8192, 2048, 8) is 2.7e8 int8 operations (0.14 us at 1,979 TOP/s) on a
// 16.8 MB (int8) or 8.4 MB (int4) packed operand, so the bytes bound it
// (5.1 / 2.6 us at the 3.35 TB/s of device memory; both operands fit the
// 50 MB L2, so repeated calls read L2).  The probe shapes are a few hundred
// KB: launch latency.
//
// Design: one block of 4 warps per 16 x 8 output tile, the warps splitting K
// in 32-sample steps and adding their four accumulators through shared
// memory at the end (enough warps in flight at N = 8).  An A fragment
// register of the packed operand is one 16-byte load of four words and a
// byte select (int8) or four nibble sign-extensions (int4); y's fragments
// are single 32-bit loads.  No atomics: results repeat.

#include "i8_mma.cuh"

namespace {

constexpr int kThreads = 128;

template <int BITS>
__global__ void unpack_kernel(const int32_t* __restrict__ x,
                              int32_t* __restrict__ out, long long r,
                              long long c) {
  constexpr int kF = 32 / BITS;
  const long long total = r * c;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / c;
    const long long col = i % c;
    const uint32_t w = static_cast<uint32_t>(__ldg(x + i));
#pragma unroll
    for (int j = 0; j < kF; ++j)
      out[(kF * row + j) * c + col] =
          static_cast<int32_t>(w << (32 - BITS * (j + 1))) >> (32 - BITS);
  }
}

// field j of a word, sign-extended, as the low byte
template <int BITS>
__device__ __forceinline__ uint32_t field_byte(uint32_t w, int j) {
  return static_cast<uint32_t>(
             static_cast<int32_t>(w << (32 - BITS * (j + 1))) >> (32 - BITS)) &
         0xFFu;
}

// four int8 values (field j of four words) in one register
template <int BITS>
__device__ __forceinline__ uint32_t pack_fields(uint4 w, int j) {
  if constexpr (BITS == 8) {
    const uint32_t sel = j | ((j + 4) << 4);
    return __byte_perm(__byte_perm(w.x, w.y, sel), __byte_perm(w.z, w.w, sel),
                       0x5410);
  } else {
    return field_byte<BITS>(w.x, j) | (field_byte<BITS>(w.y, j) << 8) |
           (field_byte<BITS>(w.z, j) << 16) | (field_byte<BITS>(w.w, j) << 24);
  }
}

using i8mma::mma_s8;

// A fragment register: row `row`, K values k..k+3, four int8
template <int BITS, bool LHS_PACKED>
__device__ __forceinline__ uint32_t load_a(const int32_t* xw, const int8_t* y,
                                           int row, int k, int K, int xc) {
  if constexpr (LHS_PACKED) {
    constexpr int kF = 32 / BITS;
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(
        xw + static_cast<size_t>(row / kF) * xc + k));
    return pack_fields<BITS>(w, row % kF);
  } else {
    return __ldg(reinterpret_cast<const uint32_t*>(
        y + static_cast<size_t>(row) * K + k));
  }
}

// B fragment register: column `col`, K values k..k+3, four int8
template <int BITS, bool LHS_PACKED>
__device__ __forceinline__ uint32_t load_b(const int32_t* xw, const int8_t* y,
                                           int col, int k, int K, int xc) {
  if constexpr (LHS_PACKED) {
    return __ldg(reinterpret_cast<const uint32_t*>(
        y + static_cast<size_t>(col) * K + k));
  } else {
    constexpr int kF = 32 / BITS;
    const uint32_t w = static_cast<uint32_t>(
        __ldg(xw + static_cast<size_t>(k / kF) * xc + col));
    if constexpr (BITS == 8) {
      return w;                    // fields 0..3 are K values k..k+3
    } else {
      const int j0 = k % kF;       // 0 or 4
      return field_byte<BITS>(w, j0) | (field_byte<BITS>(w, j0 + 1) << 8) |
             (field_byte<BITS>(w, j0 + 2) << 16) |
             (field_byte<BITS>(w, j0 + 3) << 24);
    }
  }
}

template <int BITS, bool LHS_PACKED>
__global__ void __launch_bounds__(kThreads)
int_dot_kernel(const int32_t* __restrict__ xw, const int8_t* __restrict__ y,
               int32_t* __restrict__ out, int M, int N, int K, int xc) {
  __shared__ int red[kThreads / 32][32][4];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = blockIdx.x * 16;
  const int col = blockIdx.y * 8 + g;
  int acc[4] = {0, 0, 0, 0};
  for (int k0 = 32 * warp; k0 < K; k0 += 32 * (kThreads / 32)) {
    uint32_t a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + 8 * (r & 1);
      a[r] = row < M ? load_a<BITS, LHS_PACKED>(xw, y, row,
                                                k0 + 4 * t + 16 * (r >> 1), K,
                                                xc)
                     : 0u;
    }
    uint32_t b0 = 0u, b1 = 0u;
    if (col < N) {
      b0 = load_b<BITS, LHS_PACKED>(xw, y, col, k0 + 4 * t, K, xc);
      b1 = load_b<BITS, LHS_PACKED>(xw, y, col, k0 + 16 + 4 * t, K, xc);
    }
    mma_s8(acc, a, b0, b1);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) red[warp][lane][i] = acc[i];
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][lane][i];
    const int row = row0 + g + 8 * (i >> 1);
    const int c = blockIdx.y * 8 + 2 * t + (i & 1);
    if (row < M && c < N) out[static_cast<size_t>(row) * N + c] = s;
  }
}

template <int BITS, bool LHS_PACKED>
void launch_dot(const int32_t* xw, const int8_t* y, int32_t* out, int M, int N,
                int K, int xc, cudaStream_t stream) {
  const dim3 grid((M + 15) / 16, (N + 7) / 8);
  int_dot_kernel<BITS, LHS_PACKED><<<grid, kThreads, 0, stream>>>(
      xw, y, out, M, N, K, xc);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() so a refused launch
// is seen by the caller.  bits is 4 or 8.

extern "C" int unpack_words(const void* x, void* out, long long r, long long c,
                            int bits, void* stream) {
  const long long total = r * c;
  if (total > 0) {
    const long long want = (total + kThreads - 1) / kThreads;
    const unsigned blocks = static_cast<unsigned>(want < 65536 ? want : 65536);
    auto st = static_cast<cudaStream_t>(stream);
    const auto* xi = static_cast<const int32_t*>(x);
    auto* o = static_cast<int32_t*>(out);
    if (bits == 8)
      unpack_kernel<8><<<blocks, kThreads, 0, st>>>(xi, o, r, c);
    else if (bits == 4)
      unpack_kernel<4><<<blocks, kThreads, 0, st>>>(xi, o, r, c);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// lhs_packed: x (M*bits/32, K) words, y (N, K) int8 (y transposed);
// else: y (M, K) int8, x (K*bits/32, N) words.  K % 32 == 0, xc = x's
// columns, pointers 16-byte aligned (the wrapper checks).
extern "C" int int_dot_packed(const void* x, const void* y, void* out, int M,
                              int N, int K, int xc, int bits, int lhs_packed,
                              void* stream) {
  if (M > 0 && N > 0) {
    const auto* xw = static_cast<const int32_t*>(x);
    const auto* yy = static_cast<const int8_t*>(y);
    auto* o = static_cast<int32_t*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (bits == 8 && lhs_packed)
      launch_dot<8, true>(xw, yy, o, M, N, K, xc, st);
    else if (bits == 8)
      launch_dot<8, false>(xw, yy, o, M, N, K, xc, st);
    else if (bits == 4 && lhs_packed)
      launch_dot<4, true>(xw, yy, o, M, N, K, xc, st);
    else if (bits == 4)
      launch_dot<4, false>(xw, yy, o, M, N, K, xc, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
