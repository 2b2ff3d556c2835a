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
// So the packed fields are widened to 8 bits in registers, four to a 32-bit
// fragment register, and every product runs on mma.sync.m16n8k32 (s8 or u8
// by s8).
//
// What bounds it on an H100: the lab's ingestion shape (M, K, N) =
// (8192, 2048, 8) is 2.7e8 int8 operations (0.14 us at 1,979 TOP/s) on a
// 16.8 MB (int8) or 8.4 MB (int4) packed operand, so the bytes bound it
// (5.1 / 2.6 us at the 3.35 TB/s of device memory; both operands fit the
// 50 MB L2, so repeated calls on one operand read L2).  The probe shapes are
// a few hundred KB: launch latency.
//
// The packed-lhs dot (kernel 5, the ingestion dot) is built for bytes in
// flight.  A block owns a slab of 8 word rows (32/bits * 8 output rows)
// across all of K and 8 output columns; its 8 warps split K into 1 KB runs
// of each row.  A warp copies its 8 runs (and its 8 columns' y) into shared
// memory with cp.async, all issued before the first wait, in two groups
// (the first and the second half of every run), so the whole slab is in
// flight at once: 64 KB of words a block, 128 blocks on the 132 SMs at int4
// (256 at int8, two an SM).  Each copy instruction moves 512 contiguous
// bytes (a cold read of the slab in 64-byte pieces of 8 rows at a time is
// markedly slower).  The warp decodes the first half while the second
// lands.  Each word is decoded once: thread (g, t) of the MMA's fragment
// layout reads word row g, and the four words of its 16-byte run are
// samples 4t..4t+3 of a K step (16 + 4t.. for the second run).  A 4 x 4
// byte transpose of those words (8 byte permutes) turns bytes into
// fragment registers: for int8, byte f of four words is field f of four
// samples, the A row of output row 4r + f; for int4 each transposed byte is
// then split into its two nibbles (one and-xor each).  The fields of a word
// row are the MMA's rows g and g + 8 of 32/bits / 2 m16 tiles, so one
// decode feeds all of them.  An int4 field enters the MMA as u = nibble ^ 8
// = field + 8 in [0, 15] on the u8 x s8 MMA (no sign fix), and one more MMA
// a step with A = -8 adds -8 * sum_k y[k, n], exactly; int8 fields are
// already int8.  Every block needs all of y's 16 KB: 128 blocks reading the
// same lines at once queue on them in L2, so the wrapper stages y as 8
// identical copies (a copy it makes anyway, to transpose y) and block bx
// reads copy bx % 8.  The warps' sums meet in shared memory in the output's
// layout (exact), and each warp stores 8 whole 32-byte output rows.

// The packed-rhs dot (kernel 4's dot_i8_lhs_i4_rhs probe, (8, 256) x (256,
// 512) at the lab's shape) is latency-bound: its bytes take 0.025 us, a
// launch ~1 us.  So one warp, a block of its own, owns a 16 x 8 output tile
// across all of K: it issues every load of a chunk of 8 K steps (256
// samples) before its first MMA, keeps the chunk in registers and adds it
// into one accumulator fragment; no shared memory, no barrier, one store a
// fragment row.  The MMA's K order within a step is free as long as A and
// B agree, so thread (g, t) takes samples k + 8t .. k + 8t + 7 of a step:
// one 8-byte load of y's row (A registers a0 / a2 its low and high word,
// a1 / a3 the row g + 8) and one whole word of the packed operand for int4
// (its eight nibbles, in order; b0 the low four, b1 the high four) or two
// for int8 (word rows k/4 + 2t and + 1).  A nibble becomes a byte in
// registers: a byte permute doubles each byte, two masks keep one nibble
// of each, and bit 3 times 0x1E sets the sign bits (8 x 0x1E = 0xF0 stays
// inside its byte).

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

using i8mma::mma_s8;
using i8mma::mma_u8s8;

// ---------------------------------------------------------------------------
// packed lhs: the ingestion dot
// ---------------------------------------------------------------------------

constexpr int kIngestWarps = 8;    // K split of a block
constexpr int kIngestRows = 8;     // word rows of a block: fragment rows g
constexpr int kIngestSteps = 8;    // K steps of a warp's range: 1 KB a row
constexpr int kIngestThreads = kIngestWarps * 32;
// a warp's shared tile: its 8 word rows' 1 KB runs and its 8 columns'
// 256-byte y runs, rows padded by 64 and 16 bytes so that a warp's reads of
// one fragment register fall in 32 banks (uint4 units)
constexpr int kRowU4 = kIngestSteps * 8 + 4;
constexpr int kColU4 = kIngestSteps * 2 + 1;
constexpr int kWarpU4 = kIngestRows * kRowU4 + 8 * kColU4;
constexpr int kTilesBytes = kIngestWarps * kWarpU4 * 16;
// the warps' sums, in the output's layout: warp w, block output row
// 32/BITS * r + j, column c at int w * RedWarp + r * RedRow + 8j + c; the
// 8-int pad after each word row's output rows keeps a warp's 8-byte writes
// (rows r = g of eight lanes) in distinct banks
template <int BITS>
constexpr int kRedRow = 8 * (32 / BITS) + 8;
template <int BITS>
constexpr int kRedWarp = kIngestRows * kRedRow<BITS>;
template <int BITS>
constexpr int kIngestSmem = kTilesBytes + kIngestWarps * kRedWarp<BITS> * 4;

__device__ __forceinline__ void copy16(uint4* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// d = (a & b) ^ c in one instruction (the compiler splits two constants)
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// r[f] = byte f of w0..w3 (w0's in the low byte)
__device__ __forceinline__ void transpose_bytes(uint4 w, uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(w.x, w.y, 0x5140);  // x0 y0 x1 y1
  const uint32_t t1 = __byte_perm(w.x, w.y, 0x7362);  // x2 y2 x3 y3
  const uint32_t t2 = __byte_perm(w.z, w.w, 0x5140);
  const uint32_t t3 = __byte_perm(w.z, w.w, 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// The fragment registers of four words (samples k..k+3 of one word row):
// f[j] holds field j of the four words as int8 (BITS 8) or as field + 8 in
// u8 (BITS 4), sample k in the low byte.  The byte transpose comes first:
// the nibble masks act on each byte alike, so they commute with it.
template <int BITS>
__device__ __forceinline__ void decode_run(uint4 w, uint32_t (&f)[32 / BITS]) {
  if constexpr (BITS == 8) {
    transpose_bytes(w, f);
  } else {
    constexpr uint32_t kLo = 0x0F0F0F0Fu, kOff = 0x08080808u;
    uint32_t r[4];
    transpose_bytes(w, r);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      f[2 * b] = and_xor(r[b], kLo, kOff);         // field 2b: low nibble
      f[2 * b + 1] = and_xor(r[b] >> 4, kLo, kOff);
    }
  }
}

// out (M, N) = unpack(x) (M, K) . y'.T with x (M*BITS/32, K) words and y'
// (N, K) int8 given as y_copies identical copies (block bx reads copy bx %
// y_copies).  Block (bx, by): word rows 8bx.., columns 8by..; warp w takes
// the K steps 8w..8w+7 of each 64-step chunk.  Tile q of a word row r is
// output rows 32/BITS * r + 2q (MMA row g) and + 2q + 1 (MMA row g + 8).
template <int BITS>
__global__ void __launch_bounds__(kIngestThreads)
ingest_dot_kernel(const int32_t* __restrict__ x, const int8_t* __restrict__ y,
                  int32_t* __restrict__ out, int M, int N, int K,
                  int y_copies) {
  constexpr int kF = 32 / BITS;
  constexpr int kTiles = kF / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  uint4* sx = reinterpret_cast<uint4*>(smem) + warp * kWarpU4;
  uint4* sy = sx + kIngestRows * kRowU4;
  const int rows = M / kF;
  const int row0 = blockIdx.x * kIngestRows;
  const int col0 = blockIdx.y * 8;
  const int8_t* yb = y + static_cast<size_t>(blockIdx.x % y_copies) * N * K;
  int acc[kTiles][4] = {};
  int corr[4] = {0, 0, 0, 0};          // -8 * sum_k y[k, n] (BITS 4)
  for (int k0 = 256 * warp; k0 < K; k0 += 256 * kIngestWarps) {
    __syncwarp();                      // the lanes are done with the tile
    // one copy instruction a row half: 512 contiguous bytes, K steps 4h..;
    // group h holds half h of every row (and, in group 0, y)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int r = 0; r < kIngestRows; ++r) {
        const int k = k0 + 128 * h + 4 * lane;
        const bool ok = row0 + r < rows && k < K;
        copy16(sx + r * kRowU4 + 32 * h + lane,
               x + (ok ? static_cast<size_t>(row0 + r) * K + k : 0), ok);
      }
      if (h == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // columns 2j, 2j + 1: 16 bytes a lane
          const int c = 2 * j + lane / 16;
          const int k = k0 + 16 * (lane % 16);
          const bool ok = col0 + c < N && k < K;
          copy16(sy + c * kColU4 + lane % 16,
                 yb + (ok ? static_cast<size_t>(col0 + c) * K + k : 0), ok);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 0)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncwarp();                    // the other lanes' copies are visible
#pragma unroll
      for (int i = 4 * h; i < 4 * h + 4; ++i) {  // samples k0 + 32i ..
        uint32_t f0[kF], f1[kF];
        decode_run<BITS>(sx[g * kRowU4 + 8 * i + t], f0);
        decode_run<BITS>(sx[g * kRowU4 + 8 * i + 4 + t], f1);
        const uint32_t* yc = reinterpret_cast<const uint32_t*>(sy + g * kColU4);
        const uint32_t b0 = yc[8 * i + t];
        const uint32_t b1 = yc[8 * i + 4 + t];
#pragma unroll
        for (int q = 0; q < kTiles; ++q) {
          const uint32_t frag[4] = {f0[2 * q], f0[2 * q + 1], f1[2 * q],
                                    f1[2 * q + 1]};
          if constexpr (BITS == 8)
            mma_s8(acc[q], frag, b0, b1);
          else
            mma_u8s8(acc[q], frag, b0, b1);
        }
        if constexpr (BITS == 4) {
          constexpr uint32_t kMinus8 = 0xF8F8F8F8u;
          const uint32_t m8[4] = {kMinus8, kMinus8, kMinus8, kMinus8};
          mma_s8(corr, m8, b0, b1);
        }
      }
    }
  }
  // accumulator c of tile q is output row kF g + 2q + c / 2, column 2t +
  // c % 2: two 8-byte writes a tile
  int* red = reinterpret_cast<int*>(smem + kTilesBytes);
#pragma unroll
  for (int q = 0; q < kTiles; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<int2*>(red + warp * kRedWarp<BITS> +
                               g * kRedRow<BITS> + 8 * (2 * q + e) + 2 * t) =
          make_int2(acc[q][2 * e] + corr[2 * e],
                    acc[q][2 * e + 1] + corr[2 * e + 1]);
  __syncthreads();
  // thread i: block output row i / 4, columns 2(i % 4) and + 1; a warp
  // writes 8 whole rows of 32 bytes
  for (int i = threadIdx.x; i < 2 * kTiles * 32; i += kIngestThreads) {
    const int rl = i / 4;
    const int off = (rl / kF) * kRedRow<BITS> + 8 * (rl % kF) + 2 * (i % 4);
    int s0 = 0, s1 = 0;
#pragma unroll
    for (int w = 0; w < kIngestWarps; ++w) {
      const int2 v =
          *reinterpret_cast<const int2*>(red + w * kRedWarp<BITS> + off);
      s0 += v.x;
      s1 += v.y;
    }
    const int row = kF * row0 + rl;
    const int c = col0 + 2 * (i % 4);
    if (row >= M) continue;
    int32_t* o = out + static_cast<size_t>(row) * N + c;
    if (c + 1 < N && N % 2 == 0) {
      *reinterpret_cast<int2*>(o) = make_int2(s0, s1);
    } else {
      if (c < N) o[0] = s0;
      if (c + 1 < N) o[1] = s1;
    }
  }
}

template <int BITS>
int launch_ingest(const int32_t* x, const int8_t* y, int32_t* out, int M,
                  int N, int K, int y_copies, cudaStream_t stream) {
  if (y_copies < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      ingest_dot_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kIngestSmem<BITS>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = M / (32 / BITS);
  const dim3 grid((rows + kIngestRows - 1) / kIngestRows, (N + 7) / 8);
  ingest_dot_kernel<BITS><<<grid, kIngestThreads, kIngestSmem<BITS>, stream>>>(
      x, y, out, M, N, K, y_copies);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// packed rhs: kernel 4's dot_i8_lhs_i4_rhs probe
// ---------------------------------------------------------------------------

constexpr int kRhsSteps = 8;       // K steps a chunk: 256 samples

// int8 of fields 0..3 (half 0) or 4..7 (half 1) of an int4 word, field
// 4h + i in byte i, sign-extended
__device__ __forceinline__ uint32_t nibbles_to_bytes(uint32_t w, int half) {
  const uint32_t p = __byte_perm(w, 0u, half ? 0x3322u : 0x1100u);
  const uint32_t n = (p & 0x000F000Fu) | ((p >> 4) & 0x0F000F00u);
  return n | ((n & 0x08080808u) * 0x1Eu);
}

// Read-only loads as volatile asm with a memory clobber, and the MMA with
// one: ptxas otherwise sinks half of a chunk's loads below its first MMAs,
// a second round trip to L2 (seen in the SASS).  Guarded loads give 0
// where !ok.
template <bool kGuard>
__device__ __forceinline__ uint32_t load_u32(const void* p, bool ok) {
  uint32_t v;
  if constexpr (kGuard)
    asm volatile(
        "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b32 %0, 0;\n"
        " @q ld.global.nc.u32 %0, [%1];\n}\n"
        : "=r"(v) : "l"(p), "r"(static_cast<int>(ok)) : "memory");
  else
    asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(v) : "l"(p)
                 : "memory");
  return v;
}

template <bool kGuard>
__device__ __forceinline__ uint2 load_u64(const void* p, bool ok) {
  uint2 v;
  if constexpr (kGuard)
    asm volatile(
        "{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n mov.b32 %0, 0;\n"
        " mov.b32 %1, 0;\n @q ld.global.nc.v2.u32 {%0, %1}, [%2];\n}\n"
        : "=r"(v.x), "=r"(v.y) : "l"(p), "r"(static_cast<int>(ok))
        : "memory");
  else
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(v.x), "=r"(v.y) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void mma_s8_after_loads(int (&d)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1)
      : "memory");
}

// out (M, N) = y (M, K) int8 . unpack(x) (K, N), x (K*BITS/32, xc) words;
// K % 32 == 0, y 8-byte aligned.  Block (bx, by), one warp: output rows
// 16bx.., columns 8by...  kExact (M == 8, K == 256, N % 8 == 0: the lab's
// probe) drops every guard, the absent rows g + 8 and the chunk loop: in
// a one-warp kernel bound by latency each instruction shows (the two
// instantiations are timed in turns at that shape, `general` choosing the
// guarded one).
template <int BITS, bool kExact>
__global__ void __launch_bounds__(32)
rhs_dot_kernel(const int32_t* __restrict__ xw, const int8_t* __restrict__ y,
               int32_t* __restrict__ out, int M, int N, int K, int xc) {
  constexpr bool kGuard = !kExact;
  const int g = threadIdx.x / 4;
  const int t = threadIdx.x % 4;
  const int row = blockIdx.x * 16 + g;          // and row + 8
  const int col = blockIdx.y * 8 + g;           // the B column of (g, t)
  const bool lo_ok = row < M, hi_ok = row + 8 < M, col_ok = col < N;
  const int8_t* y_lo = y + static_cast<size_t>(row) * K + 8 * t;
  const int8_t* y_hi = y_lo + static_cast<size_t>(8) * K;
  const int32_t* x_col = xw + col;
  int acc[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < (kExact ? 32 * kRhsSteps : K);
       k0 += 32 * kRhsSteps) {
    uint2 a_lo[kRhsSteps], a_hi[kRhsSteps];
    uint32_t w[kRhsSteps][2];
#pragma unroll
    for (int s = 0; s < kRhsSteps; ++s) {   // every load of the chunk first
      const int k = k0 + 32 * s;
      const bool ok = k < K;
      a_lo[s] = load_u64<kGuard>(y_lo + k, ok && lo_ok);
      a_hi[s] = kExact ? make_uint2(0u, 0u)
                       : load_u64<kGuard>(y_hi + k, ok && hi_ok);
      // word row of samples k + 8t..: k/8 + t (int4), k/4 + 2t (int8)
      const int wr = BITS == 4 ? k / 8 + t : k / 4 + 2 * t;
      w[s][0] = load_u32<kGuard>(x_col + static_cast<size_t>(wr) * xc,
                                 ok && col_ok);
      if constexpr (BITS == 8)
        w[s][1] = load_u32<kGuard>(x_col + static_cast<size_t>(wr + 1) * xc,
                                   ok && col_ok);
    }
#pragma unroll
    for (int s = 0; s < kRhsSteps; ++s) {
      const uint32_t a[4] = {a_lo[s].x, a_hi[s].x, a_lo[s].y, a_hi[s].y};
      if constexpr (BITS == 8)
        mma_s8_after_loads(acc, a, w[s][0], w[s][1]);
      else
        mma_s8_after_loads(acc, a, nibbles_to_bytes(w[s][0], 0),
                           nibbles_to_bytes(w[s][0], 1));
    }
  }
  // accumulators c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
  const int c = blockIdx.y * 8 + 2 * t;
  if constexpr (kExact) {
    *reinterpret_cast<int2*>(out + static_cast<size_t>(row) * N + c) =
        make_int2(acc[0], acc[1]);
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= M || c >= N) continue;
    int32_t* o = out + static_cast<size_t>(r) * N + c;
    if (c + 1 < N && N % 2 == 0) {
      *reinterpret_cast<int2*>(o) = make_int2(acc[2 * h], acc[2 * h + 1]);
    } else {
      o[0] = acc[2 * h];
      if (c + 1 < N) o[1] = acc[2 * h + 1];
    }
  }
}

template <int BITS>
void launch_rhs(const int32_t* xw, const int8_t* y, int32_t* out, int M,
                int N, int K, int xc, bool general, cudaStream_t stream) {
  const dim3 grid((M + 15) / 16, (N + 7) / 8);
  if (!general && M == 8 && K == 32 * kRhsSteps && N % 8 == 0)
    rhs_dot_kernel<BITS, true><<<grid, 32, 0, stream>>>(xw, y, out, M, N, K,
                                                        xc);
  else
    rhs_dot_kernel<BITS, false><<<grid, 32, 0, stream>>>(xw, y, out, M, N,
                                                         K, xc);
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

// lhs_packed: x (M*bits/32, K) words, y y_copies identical (N, K) int8
// (y transposed), one after the other; else: y (M, K) int8, x (K*bits/32,
// N) words (y_copies unused; general: the guarded rhs_dot_kernel at every
// shape).  K % 32 == 0, xc = x's columns, pointers 16-byte aligned (the
// wrapper checks).
extern "C" int int_dot_packed(const void* x, const void* y, void* out, int M,
                              int N, int K, int xc, int bits, int lhs_packed,
                              int y_copies, int general, void* stream) {
  if (M > 0 && N > 0) {
    const auto* xw = static_cast<const int32_t*>(x);
    const auto* yy = static_cast<const int8_t*>(y);
    auto* o = static_cast<int32_t*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    if (bits == 8 && lhs_packed)
      return launch_ingest<8>(xw, yy, o, M, N, K, y_copies, st);
    if (bits == 4 && lhs_packed)
      return launch_ingest<4>(xw, yy, o, M, N, K, y_copies, st);
    if (bits == 8)
      launch_rhs<8>(xw, yy, o, M, N, K, xc, general != 0, st);
    else if (bits == 4)
      launch_rhs<4>(xw, yy, o, M, N, K, xc, general != 0, st);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
