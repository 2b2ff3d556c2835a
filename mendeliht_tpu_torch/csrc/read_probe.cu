// Read-bandwidth probe for Hopper (sm_90a): c + sum(words) in wrapping
// 32-bit integer arithmetic.
//
// Replaces mendeliht_tpu/utils/profiling.py::_pallas_reader (driven there by
// stream_bandwidth_pallas): a tiled sum-reduce of the packed words whose
// rate is the read ceiling that the score kernels' roofline shares divide
// by.
//
// What bounds it on an H100: device-memory reads alone.  One integer add
// per 4-byte word is far below the card's issue rate, so the kernel's
// bytes per second over a fresh read of the words (2.56 GB at 10k x 1M,
// far past the 50 MB L2) is the card's measured read ceiling.
//
// Design: a grid-stride loop of 16-byte loads, four in flight per thread
// and a few blocks per SM, so enough bytes are in flight to cover the
// memory latency; loads are marked streaming (evict first), as each word is
// read once.  Each block reduces its threads' uint32 sums by warp shuffles
// and shared memory, then adds its sum to the output with one integer
// atomicAdd.  Integer addition is exact and order-free, so the result
// repeats run to run.  The output holds c on entry (the wrapper copies it
// there), so the result is c + sum(words).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;           // 16-byte loads in flight per thread
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint32_t sum4(uint4 v) {
  return v.x + v.y + v.z + v.w;
}

__global__ void __launch_bounds__(kThreads)
read_words_kernel(const uint4* __restrict__ w4, long long n16,
                  const uint32_t* __restrict__ tail, int n_tail,
                  uint32_t* __restrict__ out) {
  uint32_t s = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n16; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(w4 + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += sum4(v[u]);
  }
  for (; i < n16; i += stride) s += sum4(__ldcs(w4 + i));
  if (blockIdx.x == 0 && threadIdx.x < n_tail) s += tail[threadIdx.x];

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  __shared__ uint32_t part[kThreads / 32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? part[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) atomicAdd(out, s);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): adds the sum of `count` int32
// words at `words` (16-byte aligned) to the int32 at `out`.  Launches on
// `stream`, does not synchronise, and returns the first CUDA error.
extern "C" int read_words(const void* words, long long count, void* out,
                          void* stream) {
  if (count <= 0) return 0;
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n16 = count / 4;
  const int n_tail = static_cast<int>(count % 4);
  const long long need = (n16 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      need < 1 ? 1 : (need < sms * kBlocksPerSm ? need : sms * kBlocksPerSm));
  const auto* w = static_cast<const uint32_t*>(words);
  read_words_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(w), n16, w + 4 * n16, n_tail,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
