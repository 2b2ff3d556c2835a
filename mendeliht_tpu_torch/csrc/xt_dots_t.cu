// Fused 2-bit genotype decode + multi-RHS score X'R over the transposed
// per-SNP words, for Hopper (sm_90a).
//
// Replaces mendeliht_tpu/ops/pallas_kernels.py::_kernel_t (driven there by
// _xt_dots_chunk_t / xt_dots_words_t; layout from build_words_t).  Same
// contract, own design:
//
//   words_t (nw = n4/4, p_all = 4*p4) words, read as uint32: word (w, j)
//           holds bytes 4w..4w+3 of SNP j's crumb-transposed row, so crumb q
//           of its byte b is sample q*n4 + 4w + b
//   rhs     (m, n_pad = 4*n4) f32, row-major (one RHS column per row)
//   out     A = V'R, M = Miss'R (optional), S = V^2'R (optional),
//           each (m, p_all) f32, row-major
//
// Decode per 32-bit word, 16 crumbs at once (decode algebra of
// mendeliht_tpu/ops/decode.py): h = (t >> 1) & 0x55555555 is the hi bit of
// every crumb, v = h + (h & t) value-codes every crumb into {0,1,2},
// miss = lo & ~hi, and V^2 = 3V - 2H with H the hi-bit dot.
//
// Numerics: plain f32 FMAs on the CUDA cores, no quantization of R (the TPU
// kernel splits R into three int8 digit planes and runs the decoded tile as
// the int8 MXU's stationary weights; that blocking is not carried over).
// Zero crumbs are multiplied like any other, so a NaN in an R column poisons
// that column's outputs exactly as the f32 reference does.
//
// What bounds it on an H100: at m = 1 the pass is a GEMV over 2-bit data
// (2.56 GB of words at 10k x 1M), bound by the bytes and by the issue of the
// decode (a byte permute and a subtract per crumb).  At cv widths (m = 100)
// it is bound by f32 FMAs, p*n*m of them per output.
//
// Design: the layout makes the SNP axis contiguous, so each thread owns four
// adjacent SNP columns and walks the sample words w: one 16-byte load brings
// the four SNPs' words, consecutive threads read consecutive addresses
// (512 coalesced bytes per warp), and no cross-thread reduction is needed.
// A block of 128 threads (512 SNPs) stages R tiles of MC columns x 4 crumb
// planes x 4*kTw samples in shared memory, laid out [plane][sample][column]:
// every thread reads the same R values at the same time (a broadcast, no
// bank conflict), as 16-byte loads, and each R value feeds four SNPs.  Each
// word is decoded once for all MC columns of a chunk (MC = 1 for a single
// column, else 8: chunks of 16 were only 1% faster at m = 100 on an H100);
// a crumb becomes a float by a byte permute into the mantissa of 2^23 and
// one subtract.
// Accumulators stay in registers (4 SNPs x MC columns x up to 3 outputs)
// for one tile of 4*kTs = 512 samples, then are added into the thread's own
// outputs in device memory: a two-level sum, so the f32 rounding grows with
// sqrt(512 + n/512) rather than with sqrt(n), and no extra registers hold
// the running totals (the output slab of the resident blocks stays in L2).
// No atomics: results repeat run to run.  Padding is inert: samples past n
// are code 0 with R = 0 there, and SNP columns past p are zero words that
// the caller slices off.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // threads per block, 4 SNPs each
constexpr int kTw = 32;              // sample words per shared R tile
constexpr int kTs = 4 * kTw;         // samples per crumb plane of a tile

// 0x4B000000 is 2^23 as a float; its low mantissa byte replaced by a crumb
// x in {0..3} is 2^23 + x exactly, so subtracting 2^23 gives float(x).
__device__ __forceinline__ float crumb_byte(uint32_t planes, int b) {
  return __uint_as_float(__byte_perm(planes, 0x4B000000u, 0x7540u + b)) -
         8388608.0f;
}

// The MC column values of one sample from a [sample][column] tile row.
template <int MC>
__device__ __forceinline__ void load_r(const float* src, float (&r)[MC]) {
  if constexpr (MC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < MC; c += 4) {
      const float4 f = *reinterpret_cast<const float4*>(src + c);
      r[c] = f.x;
      r[c + 1] = f.y;
      r[c + 2] = f.z;
      r[c + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < MC; ++c) r[c] = src[c];
  }
}

// Stores (first tile) or adds one tile's partial sums of 4 SNPs x nc
// columns into the thread's outputs at out + o + c*p_all.
template <int MC>
__device__ __forceinline__ void flush(float* out, size_t o, int p_all, int nc,
                                      const float (&acc)[4][MC], bool first) {
#pragma unroll
  for (int c = 0; c < MC; ++c) {
    if (c >= nc) break;
    float4* dst =
        reinterpret_cast<float4*>(out + o + static_cast<size_t>(c) * p_all);
    float4 v = make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    if (!first) {
      const float4 t = *dst;
      v.x += t.x;
      v.y += t.y;
      v.z += t.z;
      v.w += t.w;
    }
    *dst = v;
  }
}

template <int MC, bool MISS, bool SQ>
__global__ void __launch_bounds__(kThreads)
xt_dots_t_kernel(const uint4* __restrict__ words_t,
                 const float* __restrict__ rhs, float* __restrict__ A,
                 float* __restrict__ M, float* __restrict__ S, int nw,
                 int p_all, int m) {
  __shared__ __align__(16) float tile[4 * kTs * MC];  // [plane][sample][col]
  const int quads = p_all / 4;                       // uint4 per words_t row
  const int col = blockIdx.x * kThreads + threadIdx.x;  // SNPs 4col..4col+3
  const bool col_ok = col < quads;
  const uint4* wcol = words_t + (col_ok ? col : 0);
  const int n4 = 4 * nw;
  const size_t n_pad = 4 * static_cast<size_t>(n4);

  for (int c0 = 0; c0 < m; c0 += MC) {
    const int nc = min(MC, m - c0);
    const size_t o = static_cast<size_t>(c0) * p_all + 4 * col;
    for (int w0 = 0; w0 < nw; w0 += kTw) {
      const int tw = min(kTw, nw - w0);
      __syncthreads();                       // previous tile fully consumed
      for (int i = threadIdx.x; i < 4 * kTs * MC; i += kThreads) {
        const int j = i % kTs;               // sample in the tile's plane
        const int q = (i / kTs) % 4;
        const int c = i / (4 * kTs);
        float r = 0.f;
        if (c < nc && j < 4 * tw)
          r = rhs[static_cast<size_t>(c0 + c) * n_pad +
                  static_cast<size_t>(q) * n4 + 4 * w0 + j];
        tile[(q * kTs + j) * MC + c] = r;
      }
      __syncthreads();
      if (!col_ok) continue;

      float acc_a[4][MC];
      float acc_m[4][MC];
      float acc_h[4][MC];  // hi-bit dots H; S = 3A - 2H after the last tile
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          acc_a[k][c] = 0.f;
          acc_m[k][c] = 0.f;
          acc_h[k][c] = 0.f;
        }
      for (int jw = 0; jw < tw; ++jw) {
        const uint4 t4 = __ldg(wcol + static_cast<size_t>(w0 + jw) * quads);
        const uint32_t t[4] = {t4.x, t4.y, t4.z, t4.w};
        uint32_t v[4], h[4], ms[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          h[k] = (t[k] >> 1) & 0x55555555u;
          v[k] = h[k] + (h[k] & t[k]);
          ms[k] = (t[k] & 0x55555555u) & ~h[k];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t vq[4], mq[4], hq[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            vq[k] = (v[k] >> (2 * q)) & 0x03030303u;
            mq[k] = (ms[k] >> (2 * q)) & 0x01010101u;
            hq[k] = (h[k] >> (2 * q)) & 0x01010101u;
          }
          const float* rq = tile + (q * kTs + 4 * jw) * MC;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            float r[MC];
            load_r<MC>(rq + b * MC, r);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float fv = crumb_byte(vq[k], b);
#pragma unroll
              for (int c = 0; c < MC; ++c)
                acc_a[k][c] = fmaf(fv, r[c], acc_a[k][c]);
              if (MISS) {
                const float fm = crumb_byte(mq[k], b);
#pragma unroll
                for (int c = 0; c < MC; ++c)
                  acc_m[k][c] = fmaf(fm, r[c], acc_m[k][c]);
              }
              if (SQ) {
                const float fh = crumb_byte(hq[k], b);
#pragma unroll
                for (int c = 0; c < MC; ++c)
                  acc_h[k][c] = fmaf(fh, r[c], acc_h[k][c]);
              }
            }
          }
        }
      }
      flush<MC>(A, o, p_all, nc, acc_a, w0 == 0);
      if (MISS) flush<MC>(M, o, p_all, nc, acc_m, w0 == 0);
      if (SQ) flush<MC>(S, o, p_all, nc, acc_h, w0 == 0);
    }

    // S holds the summed H so far: turn the thread's own entries into S
    if (!SQ || !col_ok) continue;
    for (int c = 0; c < nc; ++c) {
      const size_t oc = o + static_cast<size_t>(c) * p_all;
      const float4 a = *reinterpret_cast<const float4*>(A + oc);
      float4* s = reinterpret_cast<float4*>(S + oc);
      const float4 h = *s;
      *s = make_float4(3.f * a.x - 2.f * h.x, 3.f * a.y - 2.f * h.y,
                       3.f * a.z - 2.f * h.z, 3.f * a.w - 2.f * h.w);
    }
  }
}

template <int MC, bool MISS, bool SQ>
void launch(const uint4* w, const float* r, float* A, float* M, float* S,
            int nw, int p_all, int m, cudaStream_t stream) {
  const dim3 grid((p_all / 4 + kThreads - 1) / kThreads);
  xt_dots_t_kernel<MC, MISS, SQ><<<grid, kThreads, 0, stream>>>(
      w, r, A, M, S, nw, p_all, m);
}

template <int MC>
void launch_any(const uint4* w, const float* r, float* A, float* M, float* S,
                int nw, int p_all, int m, bool miss, bool sq,
                cudaStream_t stream) {
  if (miss && sq)
    launch<MC, true, true>(w, r, A, M, S, nw, p_all, m, stream);
  else if (miss)
    launch<MC, true, false>(w, r, A, M, S, nw, p_all, m, stream);
  else if (sq)
    launch<MC, false, true>(w, r, A, M, S, nw, p_all, m, stream);
  else
    launch<MC, false, false>(w, r, A, M, S, nw, p_all, m, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  p_all must be a multiple of 4
// and every pointer 16-byte aligned (the wrapper checks both).  M / S may be
// null when not wanted.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() so a refused launch is seen by the caller.
extern "C" int xt_dots_words_t(const void* words_t, const void* rhs, void* A,
                               void* M, void* S, int nw, int p_all, int m,
                               int want_missing, int want_sq, void* stream) {
  if (p_all > 0 && m > 0) {
    const auto* w = static_cast<const uint4*>(words_t);
    const auto* r = static_cast<const float*>(rhs);
    auto* a = static_cast<float*>(A);
    auto* mm = static_cast<float*>(M);
    auto* s = static_cast<float*>(S);
    auto st = static_cast<cudaStream_t>(stream);
    if (m == 1)
      launch_any<1>(w, r, a, mm, s, nw, p_all, m, want_missing, want_sq, st);
    else
      launch_any<8>(w, r, a, mm, s, nw, p_all, m, want_missing, want_sq, st);
  }
  return static_cast<int>(cudaGetLastError());
}
