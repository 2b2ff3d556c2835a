// The round-3 kernel probe's read and decode kernels on Hopper (sm_90a).
//
// Replaces two pallas_calls of tools/kernel_probe.py (its third,
// xt_i8_rounds, is kernel 7 in csrc/xt_dots_t.cu's ROW layout):
//
// 1. stream_xor (body _kernel_stream): out (tp, nw) int32, row r the XOR of
//    words[i*tp + r] + seed over the row tiles i.
// 2. decode_only (body _kernel_decode_only): out (tp, tw) int32, the XOR over
//    every (tp, tw) tile of the 16-crumb value sum of words + seed (an
//    exact integer sum: the reference's round order does not change it).
//    On the TPU the grid runs in order and each step XORs its tile into one
//    resident output block.  Here each thread owns one output element and
//    loops over the tiles itself, eight independent loads in flight, with
//    neighbouring threads on neighbouring words: no atomics, and the result
//    does not depend on scheduling.  Rows and word columns past the array
//    are absent (they contribute nothing); the reference leaves a ragged
//    last tile undefined.  All arithmetic is uint32, so words + seed wraps as
//    in the reference's int32.
//
// Bound: the words' bytes for both (2.56 GB of quad words at 10k x 1M read
// in ~0.77 ms at 3.35 TB/s).  The reference sums the 16 crumbs of the
// recode v = h + (h & t), h = (t >> 1) & 0x55555555, one (shift, and, add)
// each: ~36 integer instructions a word, more than the card's 16.7 T int32
// op/s can issue in the time of the read.  Each crumb of v is h's bit plus
// (h & t)'s bit at that crumb (at most 2, no carry), and both hold bits
// only at even positions, so the sum is popc(h) + popc(h & t): 2 POPC (a
// quarter of the int32 rate) and ~6 more operations a word, ~0.3 ms at that
// size, under the read.  The two kernels share the load skeleton, so both
// are bound by the same reads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kXorThreads = 256;
constexpr int kUnroll = 8;                    // independent loads in flight

// the sum of the 16 crumb values {0, 1, 2} of a word (missing -> 0): the
// recode v = h + (h & t), h = (t >> 1) & 0x55555555, has crumbs h_i + (h&t)_i
__device__ __forceinline__ uint32_t crumb_sum(uint32_t t) {
  const uint32_t h = (t >> 1) & 0x55555555u;
  return __popc(h) + __popc(h & t);
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
// xor_tiles: words (p, nw), seed a (1, 1) int32 on the card, out (tp, tw);
// decode 0 is stream_xor (tw = nw), 1 decode_only.
extern "C" int xor_tiles(const void* words, const void* seed, void* out,
                         long long p, long long nw, int tp, int tw,
                         int decode, void* stream) {
  return decode ? launch_xor<true>(words, seed, out, p, nw, tp, tw, stream)
                : launch_xor<false>(words, seed, out, p, nw, tp, tw, stream);
}
