// The exact canonicalization of one ring element held in shared memory, as a
// block-wide device function: the row body of csrc/normmod.cu, also run by
// the inverse sqrt2 top merge (csrc/sqrt2_top.cu) as its fused norm tail.
//
// out = normmod(v * 2^s mod 2^(16L)+1) for a static shift s = (neg ? W : 0)
// + 16 kd + b: the shift (rotation, sub-digit shift when b != 0, sign), two
// carry passes (digits now in [-1, 2^16]), then the exact carry: each
// digit's carry transition f(cin) = floor((d + cin) / 2^16) maps {-1,0,1}
// to {-1,0,1}; an inclusive scan composes them (packed 2 bits per input
// value), cin_i is the prefix before i evaluated at 0, and the row's
// carry-out c folds back in at digit 0 as -c (2^W == -1) with a ripple that
// keeps the -1 form [-1, 0, ...] (limb.py:28-32, 258-287; fold_carry_out,
// also run by the long-row kernel of csrc/normmod.cu).  The carry scan is a
// Hillis-Steele scan over the L transitions (log2 L steps); the ripple a
// block-wide min-reduction of the first non-propagating digit.
#pragma once

#include "common.cuh"

namespace mf {

// transition code: bits 2(c+1)..2(c+1)+1 hold f(c) + 1 for c in {-1, 0, 1}
__device__ __forceinline__ int tr_apply(int code, int c) {
  return ((code >> (2 * (c + 1))) & 3) - 1;
}

__device__ __forceinline__ int tr_make(int d) {
  return (((d - 1) >> 16) + 1) | (((d >> 16) + 1) << 2) | ((((d + 1) >> 16) + 1) << 4);
}

// later o earlier: the transition of two consecutive digit ranges
__device__ __forceinline__ int tr_compose(int later, int earlier) {
  int r = 0;
  for (int c = -1; c <= 1; ++c) r |= (tr_apply(later, tr_apply(earlier, c)) + 1) << (2 * (c + 1));
  return r;
}

// out = r - cout (mod p) for canonical digits r (no -1 form) and a carry-out
// cout in {-1, 0, 1}: a +1 ripples through the leading 0xffff digits (cout
// == -1), a -1 through the leading zero digits (cout == +1); when every digit
// propagates the result is the -1 form.  out may alias r (each thread
// rewrites only digits it read); first: a shared int.  Every thread of the
// block calls it; it ends in __syncthreads.
__device__ inline void fold_carry_out(const int* r, int* out, int cout, int* first, int L) {
  if (threadIdx.x == 0) *first = L;
  __syncthreads();
  if (cout != 0) {
    const int prop = cout == -1 ? DIGIT_MASK : 0;
    for (int i = threadIdx.x; i < L; i += blockDim.x)
      if (r[i] != prop) atomicMin(first, i);
  }
  __syncthreads();
  const int f = *first;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int v = r[i];
    int o;
    if (cout == 0) o = v;
    else if (f == L) o = i == 0 ? -1 : 0;
    else if (cout == -1) o = i < f ? 0 : (i == f ? v + 1 : v);
    else o = i < f ? DIGIT_MASK : (i == f ? v - 1 : v);
    out[i] = o;
  }
  __syncthreads();
}

// A: the row (L ints, shared, filled and synchronised by the caller); B, C:
// L-int shared scratch; first: a shared int.  All three buffers are
// overwritten.  outr: the L output digits (global).  Every thread of the
// block calls it; it ends in __syncthreads, so the caller may refill A.
__device__ inline void normmod_row(int* A, int* B, int* C, int* first, int L, int kd, int b,
                                   int neg, int* outr) {
  // static shift: rotate, sub-digit shift if b, sign
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    int v = rot_digit(A, i, kd, L);
    if (b) v = shift_bits_digit(v, rot_digit(A, i == 0 ? L - 1 : i - 1, kd, L), i, b);
    B[i] = neg ? -v : v;
  }
  __syncthreads();
  // two carry passes bound the digits into the scan's range [-1, 2^16]
  for (int i = threadIdx.x; i < L; i += blockDim.x) A[i] = carry_digit(B, i, L);
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x) B[i] = carry_digit(A, i, L);
  __syncthreads();

  // exact carries: inclusive scan of transitions, ping-pong A <-> C
  for (int i = threadIdx.x; i < L; i += blockDim.x) A[i] = tr_make(B[i]);
  __syncthreads();
  int* src = A;
  int* dst = C;
  for (int off = 1; off < L; off <<= 1) {
    for (int i = threadIdx.x; i < L; i += blockDim.x)
      dst[i] = i >= off ? tr_compose(src[i], src[i - off]) : src[i];
    __syncthreads();
    int* t = src;
    src = dst;
    dst = t;
  }
  const int cout = tr_apply(src[L - 1], 0);
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int cin = i == 0 ? 0 : tr_apply(src[i - 1], 0);
    dst[i] = (B[i] + cin) & DIGIT_MASK;
  }
  // fold_carry_out's first barrier orders these writes before its reads
  fold_carry_out(dst, outr, cout, first, L);
}

}  // namespace mf
