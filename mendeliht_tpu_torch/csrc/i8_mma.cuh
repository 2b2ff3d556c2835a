// Pieces shared by the int8 tensor-core kernels on Hopper (sm_90a): the
// int8 MMA (xt_dots_i8.cu, kernel_probe.cu, int_probe.cu), the 2-bit recode
// and the block tiling and exact combine of the two digit-plane scores
// (xt_dots_i8.cu, kernel_probe.cu).  build_library hashes this header with
// each source.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace i8mma {

// D += A x B, m16n8k32 s8 x s8 -> s32: A (16 x 32) row-major in a[4], B
// (32 x 8) column-major in b0, b1, per the PTX fragment layout
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// every crumb of a word as its value in {0, 1, 2} (missing -> 0):
// h = (t >> 1) & 0x55555555, v = h + (h & t)
__device__ __forceinline__ uint32_t recode(uint32_t t) {
  const uint32_t h = (t >> 1) & 0x55555555u;
  return h + (h & t);
}

// A block of 4 warps takes 128 SNPs at a time (two 16-SNP MMA tiles a warp,
// so each B register feeds two MMAs) and one chunk of 8*NT digit rows; B is
// staged per tile of 32 sample words, [plane][row][sample] with a 144-byte
// row stride, so a 32-bit load is one B register and 32 lanes hit 32 banks.
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMt = 2;                        // 16-SNP MMA tiles per warp
constexpr int kSnps = kWarps * kMt * 16;      // SNPs per block (sub-)tile
constexpr int kKw = 32;                       // sample words per staged tile
constexpr int kSteps = kKw / 8;               // K steps of 32 samples a tile
constexpr int kRowBytes = 4 * kKw + 16;       // padded shared row of B

template <int NT>
struct Shared {
  static constexpr int kRows = 8 * NT;
  static constexpr int kB = 4 * kRows * kRowBytes;
  static constexpr int kAccStride = kRows + 1;  // int32s per SNP, odd
  static constexpr int kAcc = kSnps * kAccStride * 4;
  static constexpr int kBytes = kB > kAcc ? kB : kAcc;
};

// The block's int32 digit sums (acc[mt][nt], the MMA's accumulator layout)
// to scores: gathered per SNP in shared memory, then each output combines
// its three digit sums as (16384*a_hi + 128*a_mid + a_lo) * scale with
// round-to-nearest f32 intrinsics (no contraction to FMA, so the order is
// the plain version's).  SNPs snp0 .. snp0+kSnps-1 below snp_end are
// written, column c0 + c of `out` at out[(c0 + c) * ld + snp].  Begins with
// a barrier (the B tile is consumed) and leaves the next write to shared
// memory to follow one.
template <int NT>
__device__ __forceinline__ void write_scores(unsigned char* smem,
                                             const int (&acc)[kMt][NT][4],
                                             long long snp0, long long snp_end,
                                             int c0, int ncols,
                                             const float* __restrict__ scale,
                                             float* __restrict__ out,
                                             long long ld) {
  constexpr int kNc = Shared<NT>::kRows / 3;    // columns per chunk
  constexpr int kS = Shared<NT>::kAccStride;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  __syncthreads();
  int* acc_s = reinterpret_cast<int*>(smem);   // [SNP of the tile][row]
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int sl = (warp * kMt + mt) * 16 + g;
      const int r = nt * 8 + 2 * t;
      acc_s[sl * kS + r] = acc[mt][nt][0];
      acc_s[sl * kS + r + 1] = acc[mt][nt][1];
      acc_s[(sl + 8) * kS + r] = acc[mt][nt][2];
      acc_s[(sl + 8) * kS + r + 1] = acc[mt][nt][3];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < kSnps * ncols; i += kThreads) {
    const int sl = i % kSnps;
    const int c = i / kSnps;
    const long long snp = snp0 + sl;
    if (snp >= snp_end) continue;
    const int* r = acc_s + sl * kS;
    const float hi = __int2float_rn(r[c]);
    const float mid = __int2float_rn(r[kNc + c]);
    const float lo = __int2float_rn(r[2 * kNc + c]);
    const float v = __fadd_rn(
        __fadd_rn(__fmul_rn(16384.0f, hi), __fmul_rn(128.0f, mid)), lo);
    out[static_cast<size_t>(c0 + c) * ld + snp] = __fmul_rn(v, scale[c0 + c]);
  }
}

}  // namespace i8mma
