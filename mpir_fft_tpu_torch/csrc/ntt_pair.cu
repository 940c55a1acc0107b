// The pair tier of the NTT-CRT pointwise product mod 2^(16M)+1 (ops/ntt.py
// _mulmod_pair, opt-in under MPIR_FFT_NTT_PAIR=1): its two link kernels.
// Adjacent base-2^16 digits join into Mp = M/2 base-2^32 pair values, five
// primes 12289, 18433, 40961, 59393, 61441 (== 1 mod 2048, Mp <= 1024; P ~
// 2^74.8) carry the coefficients, two signed-int8 planes per value, lo at
// column j and hi at column Mp + j.  Between the two links run the dense
// tier's GEMMs and its mid_planes (ntt_links.cu) on rows of Mp pairs.
//
// Replaces: mpir_fft_tpu/ops/ntt.py _mulmod_ntt_pair (ntt.py:633-654), whose
// links XLA fuses (no pallas_call):
//   pair_input_planes  <- _balanced_pass, _pair_mod (:616), _to_planes of
//                         both operands (:640-648)
//   garner_pair_carry  <- _apply_block's nonneg fold (:651-652), _mixed_radix
//                         (:542), _garner_pair_to_digits (:558-613), carry_pass
// Plain versions: ops/ntt.py pair_input_planes_plain (the planes are a
// function of exact residues, so identical) and garner_pair_carry_plain
// (the reference's byte-chunk method, the same integer sums, so identical
// digit for digit; and to the reference's own raw output).
//
// The numbers: a balanced digit is below 2^15 + 2^9 + 1, so |v| < 2^31.03
// (a pair value needs 33 bits: its residue is d0 + (d1 mod p)(2^16 mod p),
// int32 in pieces); GEMM sums below M 128^2 < 2^25.  The coefficient, |c| <
// 2^72.04 at Mp = 1024, exceeds 64 bits: Garner's mixed-radix digits v_j
// (the last centered) are spread in byte chunks -- chunk sum A[m] collects
// ck * vc for the nonzero bytes ck (byte b) of p_0..p_(j-1) and the chunks
// vc (chunk u: two bytes, then v_j >> 16) of v_j with b + u = m, below
// 2^17.1 -- and A[m] lands at pair j + m/4, the even digit where (m/2) is
// even, times 256 where m is odd, the wrapped ones negated: digit sums
// below 2^25.5, so one carry pass leaves digits in (-2^10, 2^16 + 2^10).
//
// What bounds them on an H100: device memory.  Per digit pair_input_planes
// reads 4 bytes and writes 5 x 1, garner_pair_carry reads 5 x 4 and writes
// 4.  Design: pair_input_planes takes four pairs per thread (two 16-byte
// loads, 4-byte stores of four planes a prime), a grid-stride loop over
// all rows.  garner_pair_carry is row-local (digit 2j + e takes chunk sums
// of coefficients j, j-1, j-2, then a carry from the digit below), so one
// CTA per row: each thread folds, Garners and chunks its pairs into five
// slot rows (28 Mp bytes of shared memory with the digit sums: 28 KB at Mp
// 1024, eight CTAs an SM), then the digit sums, then the carry pass.
#include "ntt_common.cuh"

namespace {

using mf::fold;
using mf::mod_center;
using mf::mod_nonneg;
using mf::mul_mod;

constexpr int kQ0 = 12289, kQ1 = 18433, kQ2 = 40961, kQ3 = 59393, kQ4 = 61441;
constexpr int kMaxPairs = 1024;
constexpr int kThreads = 256;

// a^-1 mod m (extended Euclid), for the mixed radix's constants
__host__ __device__ constexpr int inv_mod(int a, int m) {
  int t = 0, nt = 1, r = m, nr = a % m;
  while (nr != 0) {
    const int q = r / nr;
    const int t2 = t - q * nt;
    t = nt;
    nt = t2;
    const int r2 = r - q * nr;
    r = nr;
    nr = r2;
  }
  return t < 0 ? t + m : t;
}
static_assert(static_cast<long long>(kQ0) * inv_mod(kQ0, kQ4) % kQ4 == 1, "inv_mod");

// the mixed radix's place values p_0 .. p_(j-1)
constexpr unsigned long long kR1 = kQ0;
constexpr unsigned long long kR2 = kR1 * kQ1;
constexpr unsigned long long kR3 = kR2 * kQ2;
constexpr unsigned long long kR4 = kR3 * kQ3;
static_assert(kR4 < (1ULL << 59), "p_0 .. p_3 has eight bytes");

// the centered residue mod P of the pair value d0 + 2^16 d1 (balanced digits)
template <int P>
__device__ __forceinline__ int pair_residue(int d0, int d1) {
  return mod_center<P>(d0 + mul_mod<P>(mod_nonneg<P>(d1), (1 << 16) % P));
}

// four pairs' digits xb[0..7] -> prime P's planes of their values
template <int P>
__device__ __forceinline__ void pair_planes(const int (&xb)[8], signed char* lo, signed char* hi) {
  const int rc[4] = {pair_residue<P>(xb[0], xb[1]), pair_residue<P>(xb[2], xb[3]),
                     pair_residue<P>(xb[4], xb[5]), pair_residue<P>(xb[6], xb[7])};
  mf::store_planes4(rc, lo, hi);
}

// x (B, 2Mp) int32 digits -> out (5, B, 2Mp) int8: the balanced carry pass
// (input_planes_kernel's), then per prime the planes of the pairs' centered
// residues.
__global__ void __launch_bounds__(kThreads)
pair_input_planes_kernel(const int* __restrict__ x, signed char* __restrict__ out, long long B,
                         int Mp) {
  const int M = 2 * Mp;
  const int per_row = Mp / 4;
  const long long groups = B * per_row;
  const long long slab = B * static_cast<long long>(M);
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; g < groups;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = g / per_row;
    const int j0 = static_cast<int>(g - row * per_row) * 4;
    const int i0 = 2 * j0;
    const int* xr = x + row * M;
    const int4 a = *reinterpret_cast<const int4*>(xr + i0);
    const int4 b = *reinterpret_cast<const int4*>(xr + i0 + 4);
    const int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    int m_prev = (xr[i0 == 0 ? M - 1 : i0 - 1] + (1 << 15)) >> mf::DIGIT_BITS;
    if (i0 == 0) m_prev = -m_prev;
    int xb[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int m = (v[t] + (1 << 15)) >> mf::DIGIT_BITS;
      xb[t] = v[t] - mf::shl(m, mf::DIGIT_BITS) + m_prev;
      m_prev = m;
    }
    signed char* o = out + row * M + j0;
    pair_planes<kQ0>(xb, o, o + Mp);
    pair_planes<kQ1>(xb, o + slab, o + slab + Mp);
    pair_planes<kQ2>(xb, o + 2 * slab, o + 2 * slab + Mp);
    pair_planes<kQ3>(xb, o + 3 * slab, o + 3 * slab + Mp);
    pair_planes<kQ4>(xb, o + 4 * slab, o + 4 * slab + Mp);
  }
}

// one step of the mixed radix at prime Pj: (t - v_i) p_i^-1 mod Pj
template <int Pj, int Pi>
__device__ __forceinline__ int radix_step(int t, int vi) {
  constexpr int kInv = inv_mod(Pi % Pj, Pj);
  return mul_mod<Pj>(mod_nonneg<Pj>(t - vi), kInv);
}

// the chunk products of one mixed-radix digit v at place value R: A[b + u]
// += byte b of R times chunk u of v
template <unsigned long long R>
__device__ __forceinline__ void add_chunks(int (&A)[10], int v) {
  const int vc[3] = {v & 0xFF, (v >> 8) & 0xFF, v >> 16};
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const int ck = static_cast<int>((R >> (8 * b)) & 0xFF);
    if (ck == 0) continue;
#pragma unroll
    for (int u = 0; u < 3; ++u) A[b + u] += ck * vc[u];
  }
}

// s0..s4 (B, 2Mp) int32 raw inverse sums of the five primes -> out (B, 2Mp)
// int32 digits.  One CTA per row.  Slot rows (shared memory, Mp each) of
// the chunk sums, by the pair offset t = m/4 and parity e = (m/2) % 2 they
// land at: slot 0 (t 0, e 0) A0 + 256 A1, slot 1 (0, 1) A2 + 256 A3, slot 2
// (1, 0) A4 + 256 A5, slot 3 (1, 1) A6 + 256 A7, slot 4 (2, 0) A8 + 256 A9.
__global__ void __launch_bounds__(kThreads)
garner_pair_carry_kernel(const int* __restrict__ s0, const int* __restrict__ s1,
                         const int* __restrict__ s2, const int* __restrict__ s3,
                         const int* __restrict__ s4, int* __restrict__ out, int Mp) {
  extern __shared__ int slot[];                      // 5 Mp slot sums
  int* sums = slot + 5 * Mp;                         // 2 Mp digit sums
  const int M = 2 * Mp;
  const long long at = static_cast<long long>(blockIdx.x) * M;
  for (int j = threadIdx.x; j < Mp; j += blockDim.x) {
    const long long lo = at + j, hi = at + Mp + j;
    const int v0 = fold<kQ0>(s0[lo], s0[hi]);
    const int r1 = fold<kQ1>(s1[lo], s1[hi]);
    const int r2 = fold<kQ2>(s2[lo], s2[hi]);
    const int r3 = fold<kQ3>(s3[lo], s3[hi]);
    const int r4 = fold<kQ4>(s4[lo], s4[hi]);
    const int v1 = radix_step<kQ1, kQ0>(r1, v0);
    const int v2 = radix_step<kQ2, kQ1>(radix_step<kQ2, kQ0>(r2, v0), v1);
    const int v3 = radix_step<kQ3, kQ2>(radix_step<kQ3, kQ1>(radix_step<kQ3, kQ0>(r3, v0), v1), v2);
    int v4 = radix_step<kQ4, kQ3>(
        radix_step<kQ4, kQ2>(radix_step<kQ4, kQ1>(radix_step<kQ4, kQ0>(r4, v0), v1), v2), v3);
    if (v4 > kQ4 / 2) v4 -= kQ4;
    int A[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    add_chunks<1>(A, v0);
    add_chunks<kR1>(A, v1);
    add_chunks<kR2>(A, v2);
    add_chunks<kR3>(A, v3);
    add_chunks<kR4>(A, v4);
#pragma unroll
    for (int q = 0; q < 5; ++q) slot[q * Mp + j] = A[2 * q] + 256 * A[2 * q + 1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const int j = i >> 1;
    sums[i] = (i & 1) ? slot[Mp + j] + mf::rot_digit(slot + 3 * Mp, j, 1, Mp)
                      : slot[j] + mf::rot_digit(slot + 2 * Mp, j, 1, Mp) +
                            mf::rot_digit(slot + 4 * Mp, j, 2, Mp);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) out[at + i] = mf::carry_digit(sums, i, M);
}

bool bad_pairs(int Mp) { return Mp < 4 || Mp > kMaxPairs || (Mp & (Mp - 1)) != 0; }

}  // namespace

// x (B, 2Mp) int32, out (5, B, 2Mp) int8; x 16-byte aligned.
MF_EXPORT int mf_pair_input_planes(const void* x, void* out, long long B, int Mp, void* stream) {
  if (bad_pairs(Mp) || B < 0 || reinterpret_cast<unsigned long long>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  pair_input_planes_kernel<<<mf::stream_blocks(B * (Mp / 4), kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<signed char*>(out), B, Mp);
  return static_cast<int>(cudaGetLastError());
}

// s0..s4 (B, 2Mp) int32 raw inverse sums of the primes 12289, 18433, 40961,
// 59393, 61441 in that order, out (B, 2Mp) int32.
MF_EXPORT int mf_garner_pair_carry(const void* s0, const void* s1, const void* s2, const void* s3,
                                   const void* s4, void* out, long long B, int Mp, void* stream) {
  if (bad_pairs(Mp) || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(7) * Mp * sizeof(int);
  garner_pair_carry_kernel<<<static_cast<unsigned>(B), mf::row_threads(2 * Mp, kThreads), smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(s0), static_cast<const int*>(s1), static_cast<const int*>(s2),
      static_cast<const int*>(s3), static_cast<const int*>(s4), static_cast<int*>(out), Mp);
  return static_cast<int>(cudaGetLastError());
}
