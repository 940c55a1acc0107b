// The 4-step (tier-2) NTT-CRT pointwise product mod 2^(16M)+1, M = 4096 or
// 8192, the whole pipeline per row in one kernel (ops/ntt.py ntt4_fused).
//
// Replaces: mpir_fft_tpu/ops/ntt.py _fused_mulmod_fn (ntt.py:1115)'s
// kernel_ntt (:1137-1160, pallas_call :1177); its kernel_crt (:1186) is
// garner_residues in ntt_links.cu.  Plain version: ops/ntt.py
// ntt4_fused_plain -- the same exact residues, so the outputs are
// identical.  The planes, primes and 4-step layout are the links'
// (csrc/ntt4.cu).  The kernel's templates are in ntt4_fused.cuh; this file
// instantiates M 4096 and the entry point, ntt4_fused_8192.cu M 8192.
//
// ntt4_fused runs the whole pipeline of a row and prime in one CTA, its 18
// block products a row (3 primes x F1, F2 per operand, G2, G1) on the
// tensor cores.  Its two bounds at the main path's (32768, 4096) batch:
//   int8 products: 81 M (m1 + m2) multiply-adds a row (42.5 x 10^6 at M
//     4096), 2.8 x 10^12 operations at 1979 x 10^12/s: 1.41 ms;
//   the modular arithmetic the epilogues need, with no load, store or
//     address (chip_smoke.py NTT4_NEED_OPS, a 64-bit multiply-add or add
//     two operations: a fold 8, a modular product 5, a plane split 4, a
//     digit's balanced carry 4, the residue's range fix 2; 86 a value of
//     a row and prime for a product, plus 16 a digit for the two
//     operands' planes, which serve every prime), 3.7 x 10^10 at 16.7 x
//     10^12/s: 2.2 ms -- the one that binds.
// As this source spends it, with its loads, stores and addresses
// (NTT4_IMPL_OPS, a diagnostic), the epilogues' int32 work is 501
// operations a digit, 4.0 ms.  Device memory is far below both bounds:
// 20 bytes a digit (two operands read once a prime, three residues
// written), 0.8 ms.
// Design, for the products: one warpgroup's wgmma.mma_async.m64n192k32
// s8 x s8 -> s32 per 64-row tile and 192-column tile of a block (a row's
// planes are exactly one M tile at M 4096; at M 8192 F1 / G1 take two row
// tiles and F2 / G2 two column tiles of depth 384), both operands K-major
// in shared memory in the no-swizzle core-matrix layout (core_off); the
// host packs each block's column tiles so that a tile holds whole plane
// triples (columns j m + k, j < 3), and the accumulators of S0, S1, S2 of
// one output then sit in one thread (wgmma's D fragment, every 64 columns).
// The tables are read from device memory once a CTA, not once a row: a
// persistent grid of a third of the SMs a prime, one CTA an SM, keeps its
// prime's four blocks in shared memory at M 4096 (144 KB; 19 MB for the
// whole batch instead of 21 GB); at M 8192, where F2 and G2 are 144 KB
// each, it keeps F1 and G1 and streams F2's and G2's 72 KB column tiles
// from L2 through one slot by bulk copy, the next tile in flight during the
// current epilogue (432 KB a row and prime).  T and Ti (int32, fragment
// order) are read through L1 / L2 in each epilogue, prefetched to L1
// before its product.
// Design, for the epilogues: each runs in the accumulator registers.
// Exactness: raw plane sums are below 3m 128^2 < 2^22.6 in int32; a fold
// S0 + 256 S1 + 65536 S2 is exact in 64 bits (< 2^38.6) and, offset by P
// 2^23, reduced by Montgomery's REDC (R = 2^32) to [0, 2P); a product of
// two residues below 2P takes 64 bits and one REDC.  The R^-1 factors are
// carried in the tables: T R^2, Ti R^5 (the pointwise product adds R^-3),
// and G1's fold multiplies S_j by 256^j R mod P before its one reduction.
// Planes need only |v| < 2^23, so residues in [0, 2P) and the balanced
// digits (below 2^15.1, the same for every prime) are planed as they are;
// only G1's output is brought to [0, P).  After F1 and G2 the planes are
// written transposed into the next product's A buffer (byte stores, free
// of bank conflicts in the core-matrix layout); the spectrum of a is kept
// in registers and multiplied into b's in F2's epilogue; G1's residues go
// to device memory in 32-byte sectors.  Two warpgroups a CTA at M 4096
// (one at M 8192) run different rows, so one's products overlap the
// other's epilogues; within a row, the next operand's digits arrive by
// bulk copy into a stage and are planed while F2 of a (b's planes) or G1
// (the next row's a) runs on the tensor cores.  A square takes its own
// instance of the row pipeline (one forward transform a row).
#include "ntt4_fused.cuh"

namespace mf {
// ntt4_fused_8192.cu
int ntt4_fused_launch_8192(const void* a, const void* b, const void* tables, void* out,
                           long long B, int per_prime, cudaStream_t stream);
}  // namespace mf

// a, b (B, M) int32 (b == a: a square), tables (ops/ntt.py
// _ntt4_fused_tables), out (3, B, M) int32.  A persistent grid: a third
// of the SMs a prime, one CTA an SM.
MF_EXPORT int mf_ntt4_fused(const void* a, const void* b, const void* tables, void* out,
                            long long B, int M, void* stream) {
  if ((M != 4096 && M != 8192) || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_prime = sms / 3 > 0 ? sms / 3 : 1;
  const auto st = static_cast<cudaStream_t>(stream);
  return M == 4096 ? launch_fused<6>(a, b, tables, out, B, per_prime, st)
                   : mf::ntt4_fused_launch_8192(a, b, tables, out, B, per_prime, st);
}
