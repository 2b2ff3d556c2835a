// Fused 2-bit genotype decode + multi-RHS score X'R, through int8 digit
// planes of R on the tensor cores of Hopper (sm_90a): warpgroup MMAs (wgmma)
// with the decoded words as the register operand and the digit planes in
// shared memory.  One kernel body, three word layouts (template Layout):
//
//   kernel 2 (T, entry xt_dots_words_t): the transposed per-SNP words;
//     replaces mendeliht_tpu/ops/pallas_kernels.py::_kernel_t (driven there
//     by _xt_dots_chunk_t / xt_dots_words_t; layout from build_words_t).
//     Kernel 6 is its A alone with a zero guard: it replaces
//     tools/kernel_lab5.py::_kernel_T (driven by xt_dots_T), whose function
//     is kernel 2's A without the NaN guard
//   kernel 1 (QUAD, entry xt_dots_words): the quad words; replaces
//     pallas_kernels.py::_kernel (driven by _xt_dots_chunk / xt_dots_words)
//   kernel 7 (ROW, entry xt_dots_words_rows, A alone): the round-3
//     row-major words; replaces tools/kernel_probe.py::_kernel_i8_rounds
//     (driven by xt_i8_rounds).  Its 16 rounds r = 4*s2 + s1 take crumb s1
//     of byte s2 of word (j, w), sample s1*n4 + 4w + s2: the K order of
//     words_t (w, j), so the rounds are the MMA's K steps here
//
// Each computes its Pallas kernel's function exactly, and all equal each
// other bit for bit on the same genotypes.
//
// The float64 score of kernels 1 and 2 (RAW, entries xt_dots_words_raw and
// xt_dots_words_t_raw): the same body and main loop on a digit image of
// eight 7-bit digits a column (ops/decode.py::quantize_rhs_planes64), laid
// out as three 3-digit "pseudo-columns" a column (the last padded with a
// zero digit), so the loop runs unchanged at m' = 3m; only the store
// differs: it writes each accumulator's exact int32 digit sum, and the
// wrapper combines them in float64 (decode.combine_digits64).
//
// Operands and outputs:
//
//   words_t (nw, p_all) words, read as uint32: word (w, j) holds bytes
//           4w..4w+3 of SNP j's crumb-transposed row, so crumb q of its byte
//           b is sample q*n4 + 4w + b (n4 = 4*nw)
//   words   (p_all/4, n4) quad words (kernel 1), read as uint32: byte k of
//           word (i, c) is byte c of SNP 4i+k, so crumb q of it is sample
//           q*n4 + c.  The four quad words (i, 4w..4w+3) hold, byte k of
//           each in turn, exactly words_t (w, 4i+k): a 4x4 byte transpose
//   rows    (p_all, nw) row-major words (kernel 7): words_t transposed, any
//           p_all, nw a multiple of 4 (16-byte row runs)
//   digits  (passes, ksteps, 4, 2, rows/8, 8, 16) int8, ksteps = nw
//           rounded up to 32, over 8: the digit planes of R (ops/decode.py::
//           quantize_rhs_planes, |digit| <= 64) as laid out by the wrapper
//           (kernels._digit_rows_t, _digit_stages_t): for each pass and K
//           step of 32 samples, in each crumb plane q and K half, the rows'
//           8-row x 16-byte core matrices, so that a K step is one copy.
//           Plane q of a row holds samples q*n4 .., zero past n4; row
//           24b + 8d + r of a pass is digit d (hi, mid, lo) of its column
//           8b + r (for m <= 2 one 8-row group: row 2d + c, digit d of
//           column c)
//   scale   (m,) f32 per-column scale of the digits
//   guard   (m,) f32, rhs.sum(0) * 0: NaN in a column whose R is not finite
//   out     A = V'R, M = Miss'R (optional), S = V^2'R (optional), each
//           (m, p_all) f32, row-major: comb(x) = (16384*x_hi + 128*x_mid +
//           x_lo) * scale in that f32 order from the exact int32 sums x_*;
//           A = comb(a) + guard, M = comb(m) + guard, S = (3*comb(a) -
//           2*comb(h)) + guard, with H the hi-bit plane (V^2 = 3V - 2H).
//           RAW: the exact int32 sums of the value, missing and hi-bit
//           planes, each (3m, p_all) int32, row 3c + d the sum of digit row
//           d (hi, mid, lo) of (pseudo-)column c; scale and guard unread
//
// Decode per 32-bit word t, 16 crumbs at once: h = (t >> 1) & 0x55555555 is
// every crumb's hi bit, v = h + (h & t) its value in {0,1,2} (missing -> 0),
// and with lo = t & 0x55555555, lo - (lo & h) its missing indicator.  Crumb
// plane q of each, (x >> 2q) & 0x03030303 (or 0x01010101), is four int8
// values: samples q*n4 + 4w .. 4w+3 of one SNP, four consecutive K values of
// one row of the MMA's A operand.  Kernel 1 first forms these transposed
// words from the quad words: its MMA rows are permuted so that a thread's
// rows g and g+8 are SNPs 2g and 2g+1 of its warp's 16, two bytes of one
// quad row.  The thread reads two 16-byte runs of that row (K 4t.. and
// 16+4t.. of the K step) and gathers its four transposed words with 8 byte
// permutes (prmt) a K step, about 2 integer operations a word beside the
// decode's 11; the rest of the kernel is kernel 2's, and the store writes
// each accumulator row to its SNP through the same permutation.  Kernel 7's
// rows already hold the transposed words: a thread reads words t and 4+t
// of the K step from the shared rows of SNPs g and g+8, as kernel 2 does
// from its columns, and the store is kernel 2's.
//
// What bounds it on an H100 at 10k x 1M (nw = 640):
//   m = 1:   the 2.56 GB of words, 0.76 ms at 3.35 TB/s; the digit MMAs are
//            3 of the 8 rows an n8 instruction takes, and the decode is
//            about 11 integer operations a word (0.42 ms at the int32 rate).
//   m = 100: 3 digit planes x 2*n_pad*p*m int8 operations per output, 6.1e12
//            for A (3.1 ms at the 1,979 TOP/s data sheet), twice that with M.
// Design, against each:
//   - One pass over the words per call.  A block owns an SNP tile (128 SNPs,
//     a warpgroup each, or 64 SNPs when the two warpgroups split the rows)
//     and walks its sample words once: every word is read from device
//     memory once and decoded once by each warpgroup that takes its SNPs
//     (once, or twice when the rows are split), straight into wgmma's A
//     fragments, which then serve every digit row of every column and the M
//     and H planes.  The accumulators of all rows stay in registers (column
//     groups of 8 times planes at most 14 a warpgroup, 168 a thread), so one
//     pass holds m <= 112 for A or A and M (split rows past 104 and 56), 64
//     with M and H.  Wider R takes passes over 128-SNP tiles (104, 56 or 32
//     columns each), each over all the words: there the MMA work, m times
//     the words, outweighs the re-read.
//   - The tensor cores: wgmma.mma_async m64nNk32 s8 x s8 -> s32 with A (the
//     decoded words, 64 SNPs) in registers and B (the digit rows, K-major)
//     in shared memory as 8-row x 16-byte core matrices, no swizzle: N = 48
//     (two column groups) a instruction, 24 for an odd last group, 8 for
//     m <= 2.  Two A buffers where the registers allow, so one K step's MMAs
//     run while the next one decodes.  The accumulators are written by the
//     MMAs alone (an item starts at scale-d 0), which leaves ptxas nothing
//     to drain them for.  The integer sums are exact while 128 * n_pad <
//     2^31 (the wrapper checks), so the kernel equals its plain version bit
//     for bit.
//   - Asynchronous copies in a ring of 3..8 stages (as many as fit), each
//     of 1, 2 or 4 K steps: the digits by one bulk copy (cp.async.bulk, the
//     async proxy that wgmma reads by, completing on an mbarrier), the
//     words tile by cp.async: 8 sample words x the tile's SNPs a K step
//     (kernel 2), the tile's quad rows x 32 words a K step (kernel 1), or
//     the tile's SNP rows x 8 words a K step (kernel 7: one 32-byte run of
//     each row a K step), the same bytes.
//     The copies run stages - 2 ahead, so the last MMAs of a stage may still
//     read it while the next runs, and the ring runs on across the block's
//     work items.
//   - No tail wave: a persistent grid of as many blocks as are resident on
//     the card, each taking work items (SNP tile, pass) in turn.
//   - m = 1 is a bytes problem: 4 K steps a stage and 3 stages leave room
//     for several resident blocks, which keep the words in flight.
//   - What the MMAs wait on besides: each stage's own instructions (waits,
//     barrier, copies, decode, descriptors) on the SM's 8 warps.  So the
//     ring and load positions are counters (no division a stage) and a
//     descriptor is one 32-bit add to a precomputed word.
// No atomics: results repeat run to run.  Padding is inert: samples past n
// are code 0 with zero digits, words past nw and SNPs past p_all read as 0,
// and SNP columns past p are zero words the caller slices off.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the word layout a kernel reads: T words_t (kernels 2, 6), QUAD the quad
// words (kernel 1), ROW the row-major words (kernel 7)
enum class Layout { T, QUAD, ROW };

constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kMaxStages = 8;
constexpr int kMaxGroups = 14;         // column groups x planes a warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// wgmma shared-memory descriptor, no swizzle, of the B operand: start
// address >> 4 (bits 0-13) and leading byte offset >> 4 (between the two
// core matrices along K, bits 16-29) in the low word `lo`; the stride byte
// offset (between 8-row groups) of 128 bytes in the high word.  Shared
// addresses stay below 256 KB, so an offset >> 4 added to `lo` moves the
// start address alone.
__device__ __forceinline__ uint64_t smem_desc(uint32_t lo) {
  return (static_cast<uint64_t>(128 >> 4) << 32) | lo;
}

// wait until at most stages - 3 copy groups are pending (an immediate)
__device__ __forceinline__ void wait_stages(int stages) {
  switch (stages) {
    case 3: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 7: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
  }
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// r stays live, in its register, up to here: an A fragment that an
// in-flight MMA still reads
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// D (64 x N s32, the warpgroup's fragment d[N/2]) = A (64 x 32 s8, four
// registers a thread) x B (32 x N s8 at desc), + D when acc != 0
template <int N>
__device__ __forceinline__ void wgmma(int* d, const uint32_t (&a)[4],
                                      uint64_t desc, int acc);

template <>
__device__ __forceinline__ void wgmma<8>(int* d, const uint32_t (&a)[4],
                                         uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<24>(int* d, const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma<48>(int* d, const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// (16384*hi + 128*mid + lo) * scale, round to nearest at every step, no
// contraction: the plain version's f32 order
__device__ __forceinline__ float comb(int hi, int mid, int lo, float scale) {
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(16384.0f, __int2float_rn(hi)),
                                      __fmul_rn(128.0f, __int2float_rn(mid))),
                            __int2float_rn(lo));
  return __fmul_rn(v, scale);
}

struct Args {
  const uint32_t* words;
  const int8_t* digits;
  const float* scale;
  const float* guard;
  float* A;
  float* M;
  float* S;
  int nw, ksteps, p_all, m;
  int split;        // 1: the two warpgroups split the rows of 64 SNPs
  int tiles, items; // SNP tiles; work items = tiles * passes
  int rows;         // digit rows a pass (a multiple of 8)
  int cols;         // columns a pass
  int stages;       // stages in the ring (3..8)
};

// K steps of 32 samples a stage: several for the narrow widths, so that a
// barrier and a bulk copy serve more words
template <int NG>
__host__ __device__ constexpr int stage_steps() {
  return NG == 0 ? 4 : NG <= 2 ? 2 : 1;
}

// uint32 words of one SNP row of a ROW stage: its 8*ks words and 4 of
// padding, so that the rows g = 0..7 of a warp's reads start in banks 4
// apart (12 words: 0, 12, 24, 4, ..) and its 32 reads of one fragment
// register (words t of rows g) fall in 32 banks
__host__ __device__ constexpr int row_words(int ks) { return 8 * ks + 4; }

// bytes of a stage's words tile of `snps` SNPs and ks K steps: T, 8*ks
// transposed-word rows of snps + 8 words (padded: a warp's reads of one
// fragment register span 4 rows); QUAD, snps/4 quad rows of 32*ks words
// (not padded: a quarter-warp's 16-byte reads all fall in one row); ROW,
// snps rows of row_words(ks)
template <Layout L>
__host__ __device__ constexpr int words_bytes(int snps, int ks) {
  return L == Layout::QUAD  ? 32 * ks * snps
         : L == Layout::ROW ? 4 * row_words(ks) * snps
                            : 32 * ks * (snps + 8);
}

// the four transposed words of SNPs 4i+k and 4i+k+1 (k = 0 or 2, `sel`
// 0x5140 or 0x7362) in four consecutive quad words u of quad row i: byte j
// of each is byte k (k+1) of u[j]
__device__ __forceinline__ void gather(const uint4& u, uint32_t sel,
                                       uint32_t& even, uint32_t& odd) {
  const uint32_t a = __byte_perm(u.x, u.y, sel);   // x_k y_k x_k+1 y_k+1
  const uint32_t b = __byte_perm(u.z, u.w, sel);   // z_k w_k z_k+1 w_k+1
  even = __byte_perm(a, b, 0x5410);
  odd = __byte_perm(a, b, 0x7632);
}

// One block: two warpgroups, a ring of `stages` stages in dynamic shared
// memory, each [digits: KS K steps x 4 planes x 2 K halves x rows/8 core
// matrices of 128 bytes, one bulk copy][words: words_bytes<L>].  NG column
// groups of 8 a warpgroup (NG = 0: m <= 2, one 8-row group); planes A, M
// (MISS), H (SQ); L the word layout; RAW stores the exact digit sums.
template <int NG, bool MISS, bool SQ, Layout L, bool RAW>
__global__ void __launch_bounds__(kThreads, 1)
xt_dots_t_kernel(const Args args) {
  constexpr bool QUAD = L == Layout::QUAD;
  constexpr int kP = 1 + MISS + SQ;
  constexpr int kBlk = NG == 0 ? 1 : 3 * NG;   // n8 blocks a plane
  constexpr int kAcc = 4 * kBlk;               // registers a plane
  constexpr int kS = stage_steps<NG>();
  constexpr int kQRow = 32 * kS;               // a quad row's words a stage
  constexpr int kRow = row_words(kS);          // a ROW row's stride a stage
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];  // digits landed

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int snps = args.split ? 64 : 128;      // SNPs of a tile
  const int wstride = snps + 8;                // words_t row stride (uint32)
  const int n4 = 4 * args.nw;                  // quad words a row
  const int step_bytes = args.rows * 128;      // digits of one K step
  const int dig_bytes = kS * step_bytes;
  const int stage_bytes = dig_bytes + words_bytes<L>(snps, kS);
  const int rg = args.rows / 8;
  const int kstages = args.ksteps / kS;        // stages an item
  const uint32_t smem0 = smem_addr(smem);
  // the descriptors' low word at the ring's start (LBO: rg core matrices)
  const uint32_t desc0 = ((smem0 & 0x3FFFF) >> 4) | ((rg * 128 >> 4) << 16);

  // this warpgroup's SNP offset in the tile and first row group of a pass
  const int snp_off = args.split ? 0 : 64 * wg;
  const int grp0 = args.split ? NG * wg : 0;
  const int my_items =
      args.items > static_cast<int>(blockIdx.x)
          ? (args.items - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
          : 0;

  if (tid == 0) {
    for (int s = 0; s < args.stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&full[s]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // issue the copies of the next stage to load (the load pointer: item
  // ordinal li, stage ls of it, ring slot lslot), then advance it: the
  // digits by one bulk copy (the async proxy, which wgmma reads by;
  // completes on full[slot]), the words by cp.async (read by plain loads;
  // completes with the thread's copy group, one a stage)
  const int qshift = args.split ? 4 : 5;       // log2 of snps / 4
  int li = 0, ls = 0, lslot = 0;
  const int8_t* lsrc = nullptr;                // digits of (li, 0)
  const uint32_t* lwords = nullptr;            // li's tile: words_t (0,
                                               // snp0), quad row snp0/4 or
                                               // row snp0
  long long lsnps = 0;                         // SNPs of li's tile left
  auto load_next = [&]() {
    if (li < my_items) {
      if (ls == 0) {
        const int item = blockIdx.x + li * gridDim.x;
        const int tile = item % args.tiles;
        const long long snp0 = static_cast<long long>(tile) * snps;
        lsrc = args.digits +
               static_cast<size_t>(item / args.tiles) * args.ksteps * step_bytes;
        lwords = args.words + (QUAD              ? snp0 / 4 * n4
                               : L == Layout::ROW ? snp0 * args.nw
                                                  : snp0);
        lsnps = args.p_all - snp0;
      }
      const uint32_t st = smem0 + lslot * stage_bytes;
      if (tid == 0) {
        const uint32_t bar = smem_addr(&full[lslot]);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%2], [%3], %1, [%0];\n" ::"r"(bar),
            "r"(dig_bytes), "r"(st),
            "l"(lsrc + static_cast<size_t>(ls) * dig_bytes)
            : "memory");
      }
      const uint32_t wst = st + dig_bytes;
      if constexpr (QUAD) {
        // quad row r, 16-byte chunk c (words c0 + 4c ..) of the stage
        const int c0 = ls * kQRow;
        constexpr int kC = kQRow / 4;          // chunks a row: 8, 16 or 32
        for (int i = tid; i < kC << qshift; i += kThreads) {
          const int r = i / kC, c = i % kC;
          const bool ok = 4 * r < lsnps && c0 + 4 * c < n4;
          cp_async16(wst + (r * kQRow + 4 * c) * 4,
                     ok ? lwords + static_cast<size_t>(r) * n4 + c0 + 4 * c
                        : args.words,
                     ok);
        }
      } else if constexpr (L == Layout::ROW) {
        // SNP row r, 16-byte chunk c (words w0 + 4c ..) of the stage; nw is
        // a multiple of 4, so a chunk lies wholly inside or past the row
        const int w0 = ls * kS * 8;
        constexpr int kC = 2 * kS;             // chunks a row: 2, 4 or 8
        for (int i = tid; i < kC * snps; i += kThreads) {
          const int r = i / kC, c = i % kC;
          const bool ok = r < lsnps && w0 + 4 * c < args.nw;
          cp_async16(wst + (r * kRow + 4 * c) * 4,
                     ok ? lwords + static_cast<size_t>(r) * args.nw + w0 +
                              4 * c
                        : args.words,
                     ok);
        }
      } else {
        const int w0 = ls * kS * 8;
        for (int i = tid; i < (8 * kS) << qshift; i += kThreads) {
          const int r = i >> qshift, c = i & ((1 << qshift) - 1);
          const bool ok = w0 + r < args.nw && 4 * c < lsnps;
          cp_async16(wst + (r * wstride + 4 * c) * 4,
                     ok ? lwords + static_cast<size_t>(w0 + r) * args.p_all +
                              4 * c
                        : args.words,
                     ok);
        }
      }
      if (++ls == kstages) {
        ls = 0;
        ++li;
      }
      if (++lslot == args.stages) lslot = 0;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // the accumulators are written by the MMAs alone: an item's first K step
  // starts them at A x B (scale-d 0), so no other definition meets the
  // in-flight ones where the loop closes
  int acc[kP][kAcc];

  // the last K step's MMAs of a stage may still read its digits while the
  // next stage runs: the copies run stages - 2 ahead
  for (int f = 0; f < args.stages - 2; ++f) load_next();

  // A fragments: two buffers where the registers allow (at most about 200
  // with the accumulators), else one, and the MMAs drain every K step
  constexpr int kBuf = kP * kAcc + 32 * kP <= 200 ? 2 : 1;
  uint32_t fv[kBuf][4][4], fm[kBuf][4][4], fh[kBuf][4][4];
  const int sl = snp_off + 16 * warp + g;
  // kernel 1: the thread's quad row in the tile and the byte pair it takes
  const int qrow = snp_off / 4 + 4 * warp + g / 2;
  const uint32_t sel = g & 1 ? 0x7362u : 0x5140u;

  // K step s of the words at ws into A buffer bs: rows g, g+8 of the
  // warp's 16 SNPs (kernels 2, 7: SNPs g, g+8; kernel 1: SNPs 2g, 2g+1); K
  // 4t..4t+3 (word t of the K step) and 16+4t.. (word 4+t)
  auto decode = [&](const uint32_t* ws, int s, int bs) {
    uint32_t x[4];
    if constexpr (QUAD) {
      const uint4* wk =
          reinterpret_cast<const uint4*>(ws + qrow * kQRow + 32 * s + 4 * t);
      gather(wk[0], sel, x[0], x[1]);
      gather(wk[4], sel, x[2], x[3]);
    } else if constexpr (L == Layout::ROW) {
      const uint32_t* wk = ws + sl * kRow + 8 * s + t;
      x[0] = wk[0];
      x[1] = wk[8 * kRow];
      x[2] = wk[4];
      x[3] = wk[8 * kRow + 4];
    } else {
      const uint32_t* wk = ws + 8 * s * wstride;
      x[0] = wk[t * wstride + sl];
      x[1] = wk[t * wstride + sl + 8];
      x[2] = wk[(4 + t) * wstride + sl];
      x[3] = wk[(4 + t) * wstride + sl + 8];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t h = (x[r] >> 1) & 0x55555555u;
      const uint32_t v = h + (h & x[r]);
      const uint32_t lo = x[r] & 0x55555555u;
      const uint32_t ms = lo - (lo & h);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fv[bs][q][r] = (v >> (2 * q)) & 0x03030303u;
        if (MISS) fm[bs][q][r] = (ms >> (2 * q)) & 0x01010101u;
        if (SQ) fh[bs][q][r] = (h >> (2 * q)) & 0x01010101u;
      }
    }
  };

  // the MMAs of K step s of the stage in ring slot `in` from A buffer bs;
  // `first`: the item's first K step, which starts the accumulators
  auto multiply = [&](int in, int s, bool first, int bs) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int acc_on = !(first && q == 0);
      // K half 0 of plane q of K step s; this warpgroup's row groups
      const uint32_t base = desc0 + (in * stage_bytes + s * step_bytes) / 16 +
                            q * rg * 16 + grp0 * 24;
      if constexpr (NG == 0) {
        const uint64_t d = smem_desc(base);
        wgmma<8>(acc[0], fv[bs][q], d, acc_on);
        if constexpr (MISS) wgmma<8>(acc[1], fm[bs][q], d, acc_on);
        if constexpr (SQ) wgmma<8>(acc[kP - 1], fh[bs][q], d, acc_on);
      } else {
#pragma unroll
        for (int b = 0; b < NG; b += 2) {
          const uint64_t d = smem_desc(base + b * 24);
          if (b + 1 < NG) {                  // two groups: n48
            wgmma<48>(acc[0] + 12 * b, fv[bs][q], d, acc_on);
            if constexpr (MISS) wgmma<48>(acc[1] + 12 * b, fm[bs][q], d, acc_on);
            if constexpr (SQ) wgmma<48>(acc[kP - 1] + 12 * b, fh[bs][q], d, acc_on);
          } else {                           // the last of an odd NG: n24
            wgmma<24>(acc[0] + 12 * b, fv[bs][q], d, acc_on);
            if constexpr (MISS) wgmma<24>(acc[1] + 12 * b, fm[bs][q], d, acc_on);
            if constexpr (SQ) wgmma<24>(acc[kP - 1] + 12 * b, fh[bs][q], d, acc_on);
          }
        }
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the MMAs read the A registers asynchronously: a buffer is free, and
    // kept live to here, once its MMAs have completed.  With two buffers
    // these MMAs stay in flight while the next step decodes.
    if constexpr (kBuf == 2)
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    else
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        keep(fv[bs ^ (kBuf - 1)][q][r]);
        if (MISS) keep(fm[bs ^ (kBuf - 1)][q][r]);
        if (SQ) keep(fh[bs ^ (kBuf - 1)][q][r]);
      }
  };

  // stage ks of an item (f, counting the block's stages); ODD = ks & 1,
  // which with kS odd picks the buffer of each K step (that of K step
  // f*kS + s is its parity; kstages is even when kS is odd)
  int slot = 0;                                // the ring slot of stage f
  uint32_t parity = 0;                         // and its barrier's phase
  auto stage = [&](int ks, auto odd) {
    constexpr int kOdd = decltype(odd)::value;
    // stage f has landed (this thread's words, every digit), and stage f-2
    // is consumed by every thread
    wait_stages(args.stages);
    const uint32_t bar = smem_addr(&full[slot]);
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    __syncthreads();
    load_next();

    const uint32_t* ws =
        reinterpret_cast<const uint32_t*>(smem + slot * stage_bytes + dig_bytes);
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const int bs = kBuf == 2 ? (s + kOdd * kS) & 1 : 0;
      decode(ws, s, bs);
      multiply(slot, s, s == 0 && ks == 0, bs);
    }
    if (++slot == args.stages) {
      slot = 0;
      parity ^= 1;
    }
  };

  // item it of this block: its stages (pairs, so that the A buffer of each
  // K step is known at compile time), then the combine
  for (int it = 0; it < my_items; ++it) {
    int ks = 0;
    for (; ks + 1 < kstages; ks += 2) {
      stage(ks, Int<0>{});
      stage(ks + 1, Int<1>{});
    }
    if (ks < kstages) stage(ks, Int<0>{});        // kstages odd: kS even
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    const int item = blockIdx.x + it * gridDim.x;
    const int tile = item % args.tiles;
    const int col0 = (item / args.tiles) * args.cols;   // the pass's first
    // the SNPs of accumulator rows g and g+8: snp_a and snp_a + rstep
    constexpr int rstep = QUAD ? 1 : 8;
    const long long snp_a = static_cast<long long>(tile) * snps + snp_off +
                            16 * warp + (QUAD ? 2 * g : g);
    const size_t ld = args.p_all;
    if constexpr (RAW) {
      // the digit rows' exact sums: n8 blocks 3b, 3b+1, 3b+2 of a plane
      // (registers i0, i0 + 4, i0 + 8) hold digit rows 0-2 of columns 8b ..
      // 8b+7; plane p's output row 3c + d
      static_assert(NG > 0, "RAW needs column groups (m' = 3m >= 3)");
      int* out[3] = {reinterpret_cast<int*>(args.A),
                     reinterpret_cast<int*>(args.M),
                     reinterpret_cast<int*>(args.S)};
      const int plane_out[3] = {0, MISS ? 1 : 2, 2};
#pragma unroll
      for (int b = 0; b < NG; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = col0 + (grp0 + b) * 8 + 2 * t + (e & 1);
          const long long snp = snp_a + rstep * (e >> 1);
          if (c >= args.m || snp >= args.p_all) continue;
          const int i0 = 12 * b + e;
#pragma unroll
          for (int p = 0; p < kP; ++p)
#pragma unroll
            for (int d = 0; d < 3; ++d)
              out[plane_out[p]][(3 * static_cast<size_t>(c) + d) * ld + snp] =
                  acc[p][i0 + 4 * d];
        }
    } else if constexpr (NG == 0) {
      // rows 2t, 2t+1 of the group hold digit t of columns 0, 1: lane t = 0
      // gathers the mid and lo digits from lanes t+1, t+2
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int hv[kP], mv[kP], lv[kP];
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          hv[p] = acc[p][e];
          mv[p] = __shfl_down_sync(0xffffffffu, acc[p][e], 1);
          lv[p] = __shfl_down_sync(0xffffffffu, acc[p][e], 2);
        }
        const int c = col0 + (e & 1);                 // col0 = 0: one pass
        const long long snp = snp_a + rstep * (e >> 1);
        if (t != 0 || c >= args.m || snp >= args.p_all) continue;
        const float sc = args.scale[c], gd = args.guard[c];
        const float a = comb(hv[0], mv[0], lv[0], sc);
        args.A[c * ld + snp] = __fadd_rn(a, gd);
        if (MISS) args.M[c * ld + snp] = __fadd_rn(comb(hv[1], mv[1], lv[1], sc), gd);
        if (SQ) {
          const float h = comb(hv[kP - 1], mv[kP - 1], lv[kP - 1], sc);
          args.S[c * ld + snp] =
              __fadd_rn(__fsub_rn(__fmul_rn(3.0f, a), __fmul_rn(2.0f, h)), gd);
        }
      }
    } else {
      // n8 blocks 3b, 3b+1, 3b+2 hold the hi, mid, lo digits of columns
      // 8b .. 8b+7 of the warpgroup's groups: entry e of a block is SNP
      // snp_a + rstep*(e >> 1), column 2t + (e & 1)
#pragma unroll
      for (int b = 0; b < NG; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = col0 + (grp0 + b) * 8 + 2 * t + (e & 1);
          const long long snp = snp_a + rstep * (e >> 1);
          if (c >= args.m || snp >= args.p_all) continue;
          const float sc = args.scale[c], gd = args.guard[c];
          const int i0 = 12 * b + e;
          const float a = comb(acc[0][i0], acc[0][i0 + 4], acc[0][i0 + 8], sc);
          args.A[c * ld + snp] = __fadd_rn(a, gd);
          if (MISS)
            args.M[c * ld + snp] = __fadd_rn(
                comb(acc[1][i0], acc[1][i0 + 4], acc[1][i0 + 8], sc), gd);
          if (SQ) {
            const float h = comb(acc[kP - 1][i0], acc[kP - 1][i0 + 4],
                                 acc[kP - 1][i0 + 8], sc);
            args.S[c * ld + snp] = __fadd_rn(
                __fsub_rn(__fmul_rn(3.0f, a), __fmul_rn(2.0f, h)), gd);
          }
        }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int NG, bool MISS, bool SQ, Layout L, bool RAW>
int launch(Args a, cudaStream_t stream) {
  auto kern = xt_dots_t_kernel<NG, MISS, SQ, L, RAW>;
  constexpr int kS = stage_steps<NG>();
  // shared memory a block: the narrow widths leave room for three blocks
  // an SM; ROW's padded rows take 225 KB for the five stages that 220 KB
  // give T at 13 groups
  constexpr int kBudget =
      (NG <= 2 ? 72 : L == Layout::ROW ? 225 : 220) * 1024;
  const int stage_bytes =
      kS * a.rows * 128 + words_bytes<L>(a.split ? 64 : 128, kS);
  a.stages = kBudget / stage_bytes;
  a.stages = a.stages < 3 ? 3 : a.stages > kMaxStages ? kMaxStages : a.stages;
  const int smem = a.stages * stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(a.items < resident ? a.items : resident);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return 0;
}

// ROW is built for A alone (kernel 7 has no M or S); RAW for column groups
// (NG > 0) over T and QUAD
template <int NG, Layout L, bool RAW>
int launch_planes(const Args& a, bool miss, bool sq, cudaStream_t st) {
  if constexpr (RAW && (NG == 0 || L == Layout::ROW)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr bool kMore = L != Layout::ROW;
    constexpr int kP2 = kMore && 2 * NG <= kMaxGroups;  // every NG: one plane
    constexpr int kP3 = kMore && 3 * NG <= kMaxGroups;
    const int planes = 1 + miss + sq;
    if (planes == 1) return launch<NG, false, false, L, RAW>(a, st);
    if constexpr (kP2) {
      if (planes == 2 && miss) return launch<NG, true, false, L, RAW>(a, st);
      if (planes == 2) return launch<NG, false, true, L, RAW>(a, st);
    }
    if constexpr (kP3) {
      if (planes == 3) return launch<NG, true, true, L, RAW>(a, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the entry points' shared body: L and RAW as in xt_dots_t_kernel
template <Layout L, bool RAW>
int run(const void* words, const void* digits, const void* scale,
        const void* guard, void* A, void* M, void* S, int nw, int p_all,
        int m, int want_missing, int want_sq, int ng, int split, int passes,
        void* stream) {
  if (p_all > 0 && m > 0 && nw > 0) {
    Args a{};
    a.words = static_cast<const uint32_t*>(words);
    a.digits = static_cast<const int8_t*>(digits);
    a.scale = static_cast<const float*>(scale);
    a.guard = static_cast<const float*>(guard);
    a.A = static_cast<float*>(A);
    a.M = static_cast<float*>(M);
    a.S = static_cast<float*>(S);
    a.nw = nw;
    a.ksteps = 4 * ((nw + 31) / 32);           // K steps of 8 words
    a.p_all = p_all;
    a.m = m;
    a.split = split;
    const int snps = split ? 64 : 128;
    a.tiles = (p_all + snps - 1) / snps;
    const long long items = static_cast<long long>(a.tiles) * passes;
    if (items > 0x7fffffffLL || (ng == 0 && split) ||
        (L == Layout::ROW ? nw % 4 : p_all % 4) ||
        (L == Layout::QUAD && 4LL * nw >= 0x80000000LL))
      return static_cast<int>(cudaErrorInvalidValue);
    a.items = static_cast<int>(items);
    a.rows = ng == 0 ? 8 : 24 * ng * (split ? 2 : 1);
    a.cols = ng == 0 ? 2 : 8 * ng * (split ? 2 : 1);
    auto st = static_cast<cudaStream_t>(stream);
    const bool miss = want_missing != 0, sq = want_sq != 0;
    int err;
    switch (ng) {
      case 0: err = launch_planes<0, L, RAW>(a, miss, sq, st); break;
      case 1: err = launch_planes<1, L, RAW>(a, miss, sq, st); break;
      case 2: err = launch_planes<2, L, RAW>(a, miss, sq, st); break;
      case 4: err = launch_planes<4, L, RAW>(a, miss, sq, st); break;
      case 7: err = launch_planes<7, L, RAW>(a, miss, sq, st); break;
      case 13: err = launch_planes<13, L, RAW>(a, miss, sq, st); break;
      default: err = static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != 0) return err;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes), one a layout: kernel 2 (and 6)
// over words_t (nw, p_all), kernel 1 over the quad words (p_all/4, 4*nw),
// kernel 7 over the row-major words (p_all, nw), A alone.  ng (column
// groups of 8 a warpgroup and pass: 0 for m <= 2, else 1, 2, 4, 7 or 13,
// with ng times the planes at most 14), split and passes as the wrapper
// laid out `digits` (kernels._digit_rows_t, the same for every layout);
// every pointer 16-byte aligned, and p_all (T, QUAD) or nw (ROW) a
// multiple of 4 (the wrapper checks).  M / S may be null when not wanted.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so a refused launch is seen by the caller.  The
// float64 score's raw-sum entries of kernels 2 and 1 (*_raw) take the same
// arguments: m the pseudo-columns, A, M, S int32, scale and guard unread.
extern "C" int xt_dots_words_t(const void* words_t, const void* digits,
                               const void* scale, const void* guard, void* A,
                               void* M, void* S, int nw, int p_all, int m,
                               int want_missing, int want_sq, int ng,
                               int split, int passes, void* stream) {
  return run<Layout::T, false>(words_t, digits, scale, guard, A, M, S, nw,
                               p_all, m, want_missing, want_sq, ng, split,
                               passes, stream);
}

extern "C" int xt_dots_words(const void* words, const void* digits,
                             const void* scale, const void* guard, void* A,
                             void* M, void* S, int nw, int p_all, int m,
                             int want_missing, int want_sq, int ng, int split,
                             int passes, void* stream) {
  return run<Layout::QUAD, false>(words, digits, scale, guard, A, M, S, nw,
                                  p_all, m, want_missing, want_sq, ng, split,
                                  passes, stream);
}

extern "C" int xt_dots_words_rows(const void* words, const void* digits,
                                  const void* scale, const void* guard,
                                  void* A, void* M, void* S, int nw,
                                  int p_all, int m, int want_missing,
                                  int want_sq, int ng, int split, int passes,
                                  void* stream) {
  return run<Layout::ROW, false>(words, digits, scale, guard, A, M, S, nw,
                                 p_all, m, want_missing, want_sq, ng, split,
                                 passes, stream);
}

extern "C" int xt_dots_words_t_raw(const void* words_t, const void* digits,
                                   const void* scale, const void* guard,
                                   void* A, void* M, void* S, int nw,
                                   int p_all, int m, int want_missing,
                                   int want_sq, int ng, int split, int passes,
                                   void* stream) {
  return run<Layout::T, true>(words_t, digits, scale, guard, A, M, S, nw,
                              p_all, m, want_missing, want_sq, ng, split,
                              passes, stream);
}

extern "C" int xt_dots_words_raw(const void* words, const void* digits,
                                 const void* scale, const void* guard,
                                 void* A, void* M, void* S, int nw, int p_all,
                                 int m, int want_missing, int want_sq, int ng,
                                 int split, int passes, void* stream) {
  return run<Layout::QUAD, true>(words, digits, scale, guard, A, M, S, nw,
                                 p_all, m, want_missing, want_sq, ng, split,
                                 passes, stream);
}
