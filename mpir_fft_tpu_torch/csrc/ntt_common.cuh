// Modular helpers of the NTT-CRT kernels (ntt_links.cu, ntt4.cu, ntt4_fused.cu).  Every
// prime is a template argument, so each `%` is by a compile-time constant
// (a multiply-high, no division).
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

// Blocks for a grid-stride loop over `groups` items, `threads` per block.
inline unsigned stream_blocks(long long groups, int threads) {
  const long long b = (groups + threads - 1) / threads;
  return static_cast<unsigned>(b < (1LL << 20) ? b : (1LL << 20));
}

}  // namespace mf
