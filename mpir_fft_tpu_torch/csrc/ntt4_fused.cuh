// The fused 4-step NTT-CRT kernel (csrc/ntt4_fused.cu): its rows, products
// and epilogues as templates on the ring width (LG2 = log2(M) / 2: 6 at M
// 4096, 7 at M 8192), included by ntt4_fused.cu (M 4096 and the entry
// point) and ntt4_fused_8192.cu (M 8192), which compile in parallel.
#pragma once

#include <cstdint>

#include "ntt_common.cuh"

namespace {

constexpr int kQ1 = 65537, kQ2 = 114689, kQ3 = 163841;

// ---- the fused kernel ------------------------------------------------------
//
// Per prime and row: the planes of both operands, then six int8 block
// products (F1, F2 per operand, G2, G1), each a warpgroup's chain of
// wgmma.m64n192k32 (a 64-row tile of planes against one 192-column tile of
// a block, 6 or 12 K steps) with its epilogue in the accumulator registers.

constexpr int kTileN = 192;                    // one wgmma N: three planes of 64 columns
constexpr int kTileBytes = 192 * kTileN;       // an F1 / G1 block (depth 192)
constexpr int kResidentBytes = 4 * kTileBytes; // the CTA's table region

template <int LG2>
struct Fz {
  static constexpr int m1 = 64, m2 = 1 << LG2, M = m1 * m2;
  static constexpr int NT = m2 / 64;                // F1 / G1 row tiles = F2 / G2 column tiles
  static constexpr int K2 = 3 * m2;                 // depth of F2 / G2
  static constexpr int kF2Tile = K2 * kTileN;       // bytes of one F2 / G2 column tile
  static constexpr bool kResident = LG2 == 6;       // all four blocks in shared memory
  static constexpr int NWG = kResident ? 2 : 1;     // warpgroups (rows in flight) a CTA
  // per prime in the packed tables: F1, F2's tiles, G1, G2's tiles, T1, Ti1
  static constexpr long long kF2 = static_cast<long long>(NT) * kF2Tile;
  static constexpr long long kPrimeBytes = 2LL * kTileBytes + 2 * kF2 + 8LL * M;
  // a warpgroup's region: two plane buffers (3M bytes each), the stage of
  // the next operand row (4M), two mbarriers (stage, slot)
  static constexpr int kWgBytes = 10 * M + 128;
  static constexpr int kSmem = kResidentBytes + NWG * kWgBytes;
};

// -P^-1 mod 2^32 (each Newton step doubles the correct low bits)
__host__ __device__ constexpr uint32_t neg_pinv(uint32_t p) {
  uint32_t x = p;
  for (int i = 0; i < 5; ++i) x *= 2u - p * x;
  return 0u - x;
}

// Montgomery's reduction, R = 2^32: t in [0, P 2^32) -> t R^-1 mod P in [0, 2P)
template <int P>
__device__ __forceinline__ uint32_t redc(uint64_t t) {
  constexpr uint32_t kNeg = neg_pinv(P);
  const uint32_t m = static_cast<uint32_t>(t) * kNeg;
  return static_cast<uint32_t>((t + static_cast<uint64_t>(m) * P) >> 32);
}

// Raw plane sums -> (S0 + 256 S1 + 65536 S2) R^-1 mod P in [0, 2P).  The
// sum is exact in 64 bits (|S_j| <= 3m 128^2 < 2^22.6, so |sum| < 2^38.6);
// P 2^23 > 2^39 makes it nonnegative and keeps it far below P 2^32.
template <int P>
__device__ __forceinline__ uint32_t fold_redc(int s0, int s1, int s2) {
  const int lo = s0 + mf::shl(s1, 8);         // |lo| < 2^30.7: exact in 32 bits
  const long long v = (static_cast<long long>(P) << 23) + lo + 65536LL * s2;
  return redc<P>(static_cast<uint64_t>(v));
}

// (S0 C0 + S1 C1 + S2 C2) R^-1 mod P in [0, 2P) for constants C_j < P: the
// sum is below 3 2^22.6 2^17.4 < 2^42 <= P 2^26 in size
template <int P>
__device__ __forceinline__ uint32_t fold_mul_redc(int s0, int s1, int s2, uint32_t c0,
                                                  uint32_t c1, uint32_t c2) {
  const long long v = (static_cast<long long>(P) << 26) + static_cast<long long>(s0) * c0 +
                      static_cast<long long>(s1) * c1 + static_cast<long long>(s2) * c2;
  return redc<P>(static_cast<uint64_t>(v));
}

// a b R^-1 mod P in [0, 2P) for a, b < 2P
template <int P>
__device__ __forceinline__ int mont_mul(uint32_t a, uint32_t b) {
  return static_cast<int>(redc<P>(static_cast<uint64_t>(a) * b));
}

// The three int8 planes of v (|v| < 2^23: p0, p1 in [-128, 128), p2 the
// rest) at p[0], p[stride], p[2 stride].  A byte store keeps the low 8
// bits, which as int8 are ((v + 128) & 255) - 128.
__device__ __forceinline__ void put3(unsigned char* p, int stride, int v) {
  p[0] = static_cast<unsigned char>(v);
  v = (v + 128) >> 8;
  p[stride] = static_cast<unsigned char>(v);
  p[2 * stride] = static_cast<unsigned char>((v + 128) >> 8);
}

// Byte (r, q) of an R-row K-major operand in wgmma's no-swizzle layout:
// 8 x 16-byte core matrices, 8-row groups 128 bytes apart (the
// descriptor's SBO), 16-byte K slabs R 16 bytes apart (its LBO).  The
// packed tables (ops/ntt.py _ntt4_fused_tables) use it with R = 192.
template <int R>
__device__ __forceinline__ int core_off(int r, int q) {
  return (q >> 4) * (R * 16) + (r >> 3) * 128 + (r & 7) * 16 + (q & 15);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes (a multiple of 16) from global to shared memory by cp.async,
// thread tid of nthr; one commit group
__device__ __forceinline__ void copy_async(unsigned char* dst, const unsigned char* src,
                                           int bytes, int tid, int nthr) {
  for (int c = tid; c < bytes / 16; c += nthr)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst + 16 * c)),
                 "l"(src + 16 * c)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One thread: a bulk copy (TMA engine) of bytes (a multiple of 16) into
// shared memory, completing on the mbarrier bar (its expected bytes set
// here, its one arrival this thread's)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wait for the mbarrier's phase `parity` to complete
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// wgmma matrix descriptor without swizzle: start, LBO (the K slab stride), SBO 128
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// D += A B
__device__ __forceinline__ void wgmma_m64n192k32(int (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(1));
}


// the first K step: D = A B (the accumulators are outputs only, so they
// are not live before the product)
__device__ __forceinline__ void wgmma_m64n192k32_first(int (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]), "=r"(d[5]),
        "=r"(d[6]), "=r"(d[7]), "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]),
        "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15]), "=r"(d[16]), "=r"(d[17]),
        "=r"(d[18]), "=r"(d[19]), "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]),
        "=r"(d[24]), "=r"(d[25]), "=r"(d[26]), "=r"(d[27]), "=r"(d[28]), "=r"(d[29]),
        "=r"(d[30]), "=r"(d[31]), "=r"(d[32]), "=r"(d[33]), "=r"(d[34]), "=r"(d[35]),
        "=r"(d[36]), "=r"(d[37]), "=r"(d[38]), "=r"(d[39]), "=r"(d[40]), "=r"(d[41]),
        "=r"(d[42]), "=r"(d[43]), "=r"(d[44]), "=r"(d[45]), "=r"(d[46]), "=r"(d[47]),
        "=r"(d[48]), "=r"(d[49]), "=r"(d[50]), "=r"(d[51]), "=r"(d[52]), "=r"(d[53]),
        "=r"(d[54]), "=r"(d[55]), "=r"(d[56]), "=r"(d[57]), "=r"(d[58]), "=r"(d[59]),
        "=r"(d[60]), "=r"(d[61]), "=r"(d[62]), "=r"(d[63]), "=r"(d[64]), "=r"(d[65]),
        "=r"(d[66]), "=r"(d[67]), "=r"(d[68]), "=r"(d[69]), "=r"(d[70]), "=r"(d[71]),
        "=r"(d[72]), "=r"(d[73]), "=r"(d[74]), "=r"(d[75]), "=r"(d[76]), "=r"(d[77]),
        "=r"(d[78]), "=r"(d[79]), "=r"(d[80]), "=r"(d[81]), "=r"(d[82]), "=r"(d[83]),
        "=r"(d[84]), "=r"(d[85]), "=r"(d[86]), "=r"(d[87]), "=r"(d[88]), "=r"(d[89]),
        "=r"(d[90]), "=r"(d[91]), "=r"(d[92]), "=r"(d[93]), "=r"(d[94]), "=r"(d[95])
      : "l"(da), "l"(db), "r"(0));
}

// D (64 x 192 int32) = A (64 rows at a_addr, K slabs a_lbo apart) x B (a
// packed [32 KS, 192] tile at b_addr), on the tensor cores: issued here,
// complete after mma_wait (the accumulators untouched in between)
template <int KS>
__device__ __forceinline__ void mma_issue(int (&d)[96], uint32_t a_addr, uint32_t a_lbo,
                                          uint32_t b_addr) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  wgmma_m64n192k32_first(d, wg_desc(a_addr, a_lbo), wg_desc(b_addr, 16 * kTileN));
#pragma unroll
  for (int k = 1; k < KS; ++k)
    wgmma_m64n192k32(d, wg_desc(a_addr + 2 * k * a_lbo, a_lbo),
                     wg_desc(b_addr + 2 * k * 16 * kTileN, 16 * kTileN));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// each accumulator register pinned at this point of the program (no read
// of d moves above the wait)
__device__ __forceinline__ void mma_wait(int (&d)[96]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 96; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int KS>
__device__ __forceinline__ void mma_tile(int (&d)[96], uint32_t a_addr, uint32_t a_lbo,
                                         uint32_t b_addr) {
  mma_issue<KS>(d, a_addr, a_lbo, b_addr);
  mma_wait(d);
}

// One warpgroup's row pipeline for prime P.  Accumulator element s (0..31
// per plane) of thread t = 32 w + l sits at tile row 16 w + l/4 + 8 ((s>>1)&1),
// column 8 (s>>2) + 2 (l&3) + (s&1); planes j = 1, 2 at s + 32, s + 64 (the
// same column of the next 64-column plane), so each fold is in registers.
template <int P, int LG2>
struct FusedRow {
  using Z = Fz<LG2>;
  static constexpr int m2 = Z::m2, M = Z::M, NT = Z::NT;
  static constexpr uint32_t kRm = static_cast<uint32_t>((1ULL << 32) % P);         // R mod P
  static constexpr uint32_t kRm256 = static_cast<uint32_t>((1ULL << 40) % P);      // 256 R
  static constexpr uint32_t kRm65536 = static_cast<uint32_t>((1ULL << 48) % P);    // 65536 R

  const unsigned char* F2g;   // F2's tiles (global)
  const unsigned char* G2g;   // G2's tiles (global)
  const int4* T1g;            // T R^2 mod P in fragment order
  const int4* Ti1g;           // Ti R^5 mod P in fragment order
  unsigned char* smem;        // the table region
  unsigned char* P0;          // this warpgroup's two plane buffers, 3M bytes each
  unsigned char* P1;
  int* stage;                 // the next operand row (M digits), by bulk copy
  uint64_t* sbar;             // its mbarrier
  uint64_t* tbar;             // the streamed slot's mbarrier
  uint32_t sph, tph;          // their phases' parities
  int wg, t, w, l, rq, cq;

  __device__ __forceinline__ unsigned char* F1s() const { return smem; }
  __device__ __forceinline__ unsigned char* G1s() const {
    return Z::kResident ? smem + 2 * kTileBytes : smem + kTileBytes;
  }
  __device__ __forceinline__ unsigned char* slot() const { return smem + 2 * kTileBytes; }
  // an F2 / G2 column tile: resident (F2 at kTileBytes, G2 at 3 kTileBytes),
  // or the streamed slot, waited for here
  __device__ __forceinline__ uint32_t tile_at(int resident_at, int nt) {
    if (Z::kResident) return smem_addr(smem + resident_at + nt * Z::kF2Tile);
    bar_wait(tbar, tph);
    tph ^= 1;
    return smem_addr(slot());
  }

  __device__ __forceinline__ void wg_sync() const {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }
  // this thread's plane stores -> the tensor cores' (async) proxy, then the
  // warpgroup's barrier
  __device__ __forceinline__ void publish() const {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync();
  }
  // streamed tables: once every warp's product has read the slot, it takes
  // the next tile
  __device__ __forceinline__ void stream(const unsigned char* next) const {
    if (!Z::kResident) {
      wg_sync();
      if (t == 0) bulk_load(slot(), next, Z::kF2Tile, tbar);
    }
  }
  // the stage takes the row x (after every thread has read it: a publish)
  __device__ __forceinline__ void stage_row(const int* x) const {
    if (t == 0 && x) bulk_load(stage, x, 4 * M, sbar);
  }
  // this thread's share of a fragment-ordered table into L1 ahead of its epilogue
  __device__ __forceinline__ void prefetch_frag(const int4* tab, int tile) const {
    const int4* line = tab + (tile * 8 + (l >> 2)) * 128 + w * 32 + (l & 3) * 8;
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(line));
  }

  // the staged digits -> planes of the balanced carry pass into P0,
  // [i2][(j, i1)], m2 rows.  A lane takes i2's low bits (l & 7) and i1's
  // (l >> 3): conflict-free byte stores.  A balanced digit is below
  // 2^15.1 in size, so its planes serve every prime as they are.
  __device__ __forceinline__ void in_planes() {
    bar_wait(sbar, sph);
    sph ^= 1;
#pragma unroll 4
    for (int it = 0; it < M / 128; ++it) {
      const int g = it * 4 + w;
      const int i1 = (g & 15) * 4 + (l >> 3), i2 = (g >> 4) * 8 + (l & 7);
      put3(P0 + core_off<m2>(i2, i1), M, mf::balanced_digit(stage, i1 * m2 + i2, M));
    }
  }

  // F1 per row tile; epilogue: fold, times T R^2 (-> v T), planes
  // transposed into P1, [k1][(j, i2)], 64 rows
  __device__ __forceinline__ void pass_f1(int (&d)[96]) const {
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) {
      prefetch_frag(T1g, mt);
      mma_tile<6>(d, smem_addr(P0) + mt * 1024, m2 * 16, smem_addr(F1s()));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int4 tw = __ldg(T1g + (mt * 8 + i) * 128 + t);
        const uint32_t tv[4] = {static_cast<uint32_t>(tw.x), static_cast<uint32_t>(tw.y),
                                static_cast<uint32_t>(tw.z), static_cast<uint32_t>(tw.w)};
#pragma unroll
        for (int he = 0; he < 4; ++he) {
          const int s = 4 * i + he;
          const int i2 = 64 * mt + 16 * w + rq + 8 * (he >> 1), k1 = 8 * i + cq + (he & 1);
          put3(P1 + core_off<64>(k1, i2), M,
               mont_mul<P>(fold_redc<P>(d[s], d[s + 32], d[s + 64]), tv[he]));
        }
      }
    }
  }

  // F2 per column tile; epilogue: the spectrum (A R^-1) kept in fa, or its
  // product with fa (or with itself: a square), A B R^-3, as planes into
  // P0, [k1][(j, k2)], 64 rows.  next: the slot's tile after the last.
  template <class Ov>
  __device__ __forceinline__ void pass_f2(int (&d)[96], uint32_t (&fa)[32 * NT], bool keep,
                                          bool square, const unsigned char* next, Ov ov) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma_issue<Z::K2 / 32>(d, smem_addr(P1), 1024, tile_at(kTileBytes, nt));
      if (nt == 0) ov();
      mma_wait(d);
      stream(nt + 1 < NT ? F2g + (nt + 1) * Z::kF2Tile : next);
      if (keep) {
#pragma unroll
        for (int s = 0; s < 32; ++s) fa[nt * 32 + s] = fold_redc<P>(d[s], d[s + 32], d[s + 64]);
      } else {
#pragma unroll
        for (int s = 0; s < 32; ++s) {
          const uint32_t f = fold_redc<P>(d[s], d[s + 32], d[s + 64]);
          const int k1 = 16 * w + rq + 8 * ((s >> 1) & 1);
          const int k2 = 64 * nt + 8 * (s >> 2) + cq + (s & 1);
          put3(P0 + core_off<64>(k1, k2), M, mont_mul<P>(f, square ? f : fa[nt * 32 + s]));
        }
      }
    }
  }

  // G2 per column tile; epilogue: fold, times Ti R^5 (-> v Ti), planes
  // transposed into P1, [i2][(j, k1)], m2 rows
  __device__ __forceinline__ void pass_g2(int (&d)[96]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      prefetch_frag(Ti1g, nt);
      mma_tile<Z::K2 / 32>(d, smem_addr(P0), 1024, tile_at(3 * kTileBytes, nt));
      stream(nt + 1 < NT ? G2g + (nt + 1) * Z::kF2Tile : F2g);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int4 tw = __ldg(Ti1g + (nt * 8 + i) * 128 + t);
        const uint32_t tv[4] = {static_cast<uint32_t>(tw.x), static_cast<uint32_t>(tw.y),
                                static_cast<uint32_t>(tw.z), static_cast<uint32_t>(tw.w)};
#pragma unroll
        for (int he = 0; he < 4; ++he) {
          const int s = 4 * i + he;
          const int k1 = 16 * w + rq + 8 * (he >> 1), i2 = 64 * nt + 8 * i + cq + (he & 1);
          put3(P1 + core_off<m2>(i2, k1), M,
               mont_mul<P>(fold_redc<P>(d[s], d[s + 32], d[s + 64]), tv[he]));
        }
      }
    }
  }

  // G1 per row tile; epilogue: the residue (S0 + 256 S1 + 65536 S2 with the
  // factors 256^j R mod P: one reduction) in [0, P) to digit i1 m2 + i2 (a
  // lane quad's eight consecutive digits: whole 32-byte sectors)
  template <class Ov>
  __device__ __forceinline__ void pass_g1(int (&d)[96], int* o, Ov ov) {
#pragma unroll
    for (int mt = 0; mt < NT; ++mt) {
      mma_issue<6>(d, smem_addr(P1) + mt * 1024, m2 * 16, smem_addr(G1s()));
      if (mt == 0) ov();
      mma_wait(d);
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        const int i2 = 64 * mt + 16 * w + rq + 8 * ((s >> 1) & 1);
        const int i1 = 8 * (s >> 2) + cq + (s & 1);
        const uint32_t r = fold_mul_redc<P>(d[s], d[s + 32], d[s + 64], kRm, kRm256, kRm65536);
        o[i1 * m2 + i2] = static_cast<int>(min(r, r - P));
      }
    }
  }
};

// The rows of prime P: warpgroup wg of CTA x takes rows x NWG + wg, then
// every gridDim.x NWG-th.  tab: this prime's packed tables.
template <int P, int LG2, bool kSquare>
__device__ __forceinline__ void fused_rows(const int* __restrict__ a, const int* __restrict__ b,
                                           const unsigned char* __restrict__ tab,
                                           int* __restrict__ out, long long B,
                                           unsigned char* smem) {
  using Z = Fz<LG2>;
  constexpr int M = Z::M;
  FusedRow<P, LG2> R;
  const unsigned char* F1g = tab;
  R.F2g = tab + kTileBytes;
  const unsigned char* G1g = R.F2g + Z::kF2;
  R.G2g = G1g + kTileBytes;
  R.T1g = reinterpret_cast<const int4*>(R.G2g + Z::kF2);
  R.Ti1g = R.T1g + M / 4;
  R.smem = smem;
  R.wg = threadIdx.x >> 7;
  R.t = threadIdx.x & 127;
  R.w = R.t >> 5;
  R.l = R.t & 31;
  R.rq = R.l >> 2;
  R.cq = 2 * (R.l & 3);
  R.P0 = smem + kResidentBytes + R.wg * Z::kWgBytes;
  R.P1 = R.P0 + 3 * M;
  R.stage = reinterpret_cast<int*>(R.P1 + 3 * M);
  R.sbar = reinterpret_cast<uint64_t*>(R.P1 + 7 * M);
  R.tbar = R.sbar + 1;
  R.sph = R.tph = 0;
  if (R.t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(R.sbar)) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(R.tbar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // the tables this CTA keeps, loaded once: F1, F2, G1, G2; or (streamed)
  // F1, G1, and F2's first tile into the slot
  copy_async(smem, F1g, kTileBytes, threadIdx.x, blockDim.x);
  if (Z::kResident) {
    copy_async(smem + kTileBytes, R.F2g, kTileBytes, threadIdx.x, blockDim.x);
    copy_async(smem + 2 * kTileBytes, G1g, kTileBytes, threadIdx.x, blockDim.x);
    copy_async(smem + 3 * kTileBytes, R.G2g, kTileBytes, threadIdx.x, blockDim.x);
  } else {
    copy_async(smem + kTileBytes, G1g, kTileBytes, threadIdx.x, blockDim.x);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  constexpr bool square = kSquare;
  const long long step = static_cast<long long>(gridDim.x) * Z::NWG;
  long long row = static_cast<long long>(blockIdx.x) * Z::NWG + R.wg;
  int d[96];
  uint32_t fa[32 * Z::NT];
  // the first row's a into P0; the stage then takes its b (or, for a
  // square, the next row's a).  Every later operand's planes are built
  // while a product runs: b's during F2 of a, the next row's a during G1.
  if (row < B) {
    R.stage_row(a + row * M);
    if (!Z::kResident && R.t == 0) bulk_load(R.slot(), R.F2g, Z::kF2Tile, R.tbar);
    R.in_planes();
    R.publish();
    R.stage_row(!square ? b + row * M : row + step < B ? a + (row + step) * M : nullptr);
  }
  for (; row < B; row += step) {
    const long long at = row * M;
    const bool more = row + step < B;
    const int* after = more ? (square ? (row + 2 * step < B ? a + at + 2 * step * M : nullptr)
                                      : b + at + step * M)
                            : nullptr;
#pragma unroll 1
    for (int op = 0; op < (square ? 1 : 2); ++op) {
      R.pass_f1(d);
      R.publish();
      const bool keep = !square && op == 0;
      R.pass_f2(d, fa, keep, square, keep ? R.F2g : R.G2g, [&]() {
        if (keep) {
          R.in_planes();                      // b
          R.publish();
          R.stage_row(more ? a + at + step * M : nullptr);
        }
      });
    }
    R.publish();
    R.pass_g2(d);
    R.publish();
    R.pass_g1(d, out + at, [&]() {
      if (more) {
        R.in_planes();                        // the next row's a
        R.publish();
        R.stage_row(after);
      }
    });
  }
  // the slot's last load (G2's successor) lands before the CTA exits
  if (!Z::kResident && blockIdx.x * Z::NWG + R.wg < B) bar_wait(R.tbar, R.tph);
}

// a, b (B, M) int32 digits -> out (3, B, M) int32 residues of the three
// primes; grid (CTAs a prime, 3), Fz<LG2>::NWG warpgroups a CTA.
template <int LG2>
__global__ void __launch_bounds__(Fz<LG2>::NWG * 128, 1)
ntt4_fused_kernel(const int* __restrict__ a, const int* __restrict__ b,
                  const unsigned char* __restrict__ tables, int* __restrict__ out, long long B) {
  extern __shared__ __align__(128) unsigned char fz_smem[];
  using Z = Fz<LG2>;
  const unsigned char* tab = tables + blockIdx.y * Z::kPrimeBytes;
  int* o = out + blockIdx.y * B * Z::M;
  // a square (b is a) takes its own instance: one forward pass a row
  if (a == b) {
    if (blockIdx.y == 0) fused_rows<kQ1, LG2, true>(a, b, tab, o, B, fz_smem);
    else if (blockIdx.y == 1) fused_rows<kQ2, LG2, true>(a, b, tab, o, B, fz_smem);
    else fused_rows<kQ3, LG2, true>(a, b, tab, o, B, fz_smem);
  } else {
    if (blockIdx.y == 0) fused_rows<kQ1, LG2, false>(a, b, tab, o, B, fz_smem);
    else if (blockIdx.y == 1) fused_rows<kQ2, LG2, false>(a, b, tab, o, B, fz_smem);
    else fused_rows<kQ3, LG2, false>(a, b, tab, o, B, fz_smem);
  }
}

template <int LG2>
int launch_fused(const void* a, const void* b, const void* tables, void* out, long long B,
                 int per_prime, cudaStream_t stream) {
  using Z = Fz<LG2>;
  const long long want = (B + Z::NWG - 1) / Z::NWG;
  const unsigned gx = static_cast<unsigned>(want < per_prime ? want : per_prime);
  const cudaError_t err =
      mf::set_smem(reinterpret_cast<const void*>(ntt4_fused_kernel<LG2>), Z::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt4_fused_kernel<LG2><<<dim3(gx, 3), Z::NWG * 128, Z::kSmem, stream>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<const unsigned char*>(tables), static_cast<int*>(out), B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
