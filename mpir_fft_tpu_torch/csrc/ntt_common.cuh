// Modular helpers of the NTT-CRT kernels (ntt_links.cu, ntt_pair.cu, ntt4.cu,
// ntt4_fused.cu), and the two-plane fold and plane split of the dense and
// pair tiers' links.  Every prime is a template argument, so each `%` is by
// a compile-time constant (a multiply-high, no division).
#pragma once

#include "common.cuh"

namespace mf {

// v mod P in [0, P) (C's % truncates toward zero)
template <int P>
__device__ __forceinline__ int mod_nonneg(int v) {
  const int r = v % P;
  return r < 0 ? r + P : r;
}

// the centered representative of v mod P, in [-(P-1)/2, (P-1)/2]
template <int P>
__device__ __forceinline__ int mod_center(int v) {
  const int r = mod_nonneg<P>(v);
  return r > P / 2 ? r - P : r;
}

// a b mod P for a, b in [0, P): in 32 bits where P^2 fits them (the tier-1
// primes), else through a 64-bit product (the tier-2 primes are > 2^16)
template <int P>
__device__ __forceinline__ int mul_mod(int a, int b) {
  if constexpr (static_cast<long long>(P) * P < (1LL << 32)) {
    return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b) % P);
  } else {
    return static_cast<int>(static_cast<unsigned long long>(a) * static_cast<unsigned>(b) % P);
  }
}

// Digit i of the balanced carry pass of the row x (M digits):
// m_j = (x_j + 2^15) >> 16; x_i - 2^16 m_i + m_(i-1), the top carry
// wrapping negated into digit 0.
__device__ __forceinline__ int balanced_digit(const int* x, int i, int M) {
  const int m = (x[i] + (1 << 15)) >> DIGIT_BITS;
  int m_prev = (x[i == 0 ? M - 1 : i - 1] + (1 << 15)) >> DIGIT_BITS;
  if (i == 0) m_prev = -m_prev;
  return x[i] - shl(m, DIGIT_BITS) + m_prev;
}

// raw plane sums (S0, S1), |S_j| <= 2^26 -> S0 + 256 S1 mod P in [0, P);
// S1 is reduced first so the sum stays int32-exact
template <int P>
__device__ __forceinline__ int fold(int s0, int s1) {
  return mod_nonneg<P>(s0 + (mod_nonneg<P>(s1) << 8));
}

// the balanced int8 planes of a centered residue rc: rc = lo + 256 hi
__device__ __forceinline__ signed char plane_lo(int rc) {
  return static_cast<signed char>(((rc + 128) & 255) - 128);
}
__device__ __forceinline__ signed char plane_hi(int rc) {
  return static_cast<signed char>((rc - (((rc + 128) & 255) - 128)) >> 8);
}

// four centered residues -> their lo planes at lo[0..3], hi planes at hi[0..3]
__device__ __forceinline__ void store_planes4(const int (&rc)[4], signed char* lo,
                                              signed char* hi) {
  char4 l, h;
  l.x = plane_lo(rc[0]); l.y = plane_lo(rc[1]); l.z = plane_lo(rc[2]); l.w = plane_lo(rc[3]);
  h.x = plane_hi(rc[0]); h.y = plane_hi(rc[1]); h.z = plane_hi(rc[2]); h.w = plane_hi(rc[3]);
  *reinterpret_cast<char4*>(lo) = l;
  *reinterpret_cast<char4*>(hi) = h;
}

template <int P>
__device__ __forceinline__ void planes_of(const int (&v)[4], signed char* lo, signed char* hi) {
  const int rc[4] = {mod_center<P>(v[0]), mod_center<P>(v[1]), mod_center<P>(v[2]),
                     mod_center<P>(v[3])};
  store_planes4(rc, lo, hi);
}

// Blocks for a grid-stride loop over `groups` items, `threads` per block.
inline unsigned stream_blocks(long long groups, int threads) {
  const long long b = (groups + threads - 1) / threads;
  return static_cast<unsigned>(b < (1LL << 20) ? b : (1LL << 20));
}

}  // namespace mf
