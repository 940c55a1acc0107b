// Shared helpers of the Hopper kernels (built by mpir_fft_tpu_torch/kernels).
//
// Digits are redundant signed base-2^16 values in int32.  A right shift of a
// signed int is arithmetic in CUDA (floor division by 2^s), exactly as in
// torch, and every carry below relies on it.  Left shifts go through
// unsigned so that negative values shift without undefined behaviour.
#pragma once

#include <cuda_runtime.h>

#define MF_EXPORT extern "C" __attribute__((visibility("default")))

namespace mf {

constexpr int DIGIT_BITS = 16;
constexpr int DIGIT_MASK = 0xFFFF;

__device__ __forceinline__ int shl(int x, int s) {
  return static_cast<int>(static_cast<unsigned>(x) << s);
}

// Digit j of the negacyclic rotation of v by kd digits (0 <= kd < L):
// v * 2^(16 kd) mod 2^(16 L) + 1 -- wrapped digits re-enter negated.
__device__ __forceinline__ int rot_digit(const int* v, int j, int kd, int L) {
  return j >= kd ? v[j - kd] : -v[L - kd + j];
}

// Digit i of shift_bits_var(r, b) given the rotated digits r_i and r_{i-1}
// (r_{L-1} for i == 0): the overflow-safe split x*2^b = hi*2^16 + lo*2^b,
// hi = x >> (16-b), with hi moving one digit up and wrapping negated.
__device__ __forceinline__ int shift_bits_digit(int r_i, int r_prev, int i, int b) {
  const int sh = DIGIT_BITS - b;
  const int hi_prev = r_prev >> sh;
  return shl(r_i & ((1 << sh) - 1), b) + (i == 0 ? -hi_prev : hi_prev);
}

// Digit i of carry_pass of the row whose digit x is f(x): (f(i) mod 2^16)
// + floor(f(i-1) / 2^16), the top digit's carry wrapping to digit 0
// negated (2^W == -1).
template <class F>
__device__ __forceinline__ int carry_of(F f, int i, int L) {
  const int c = f(i == 0 ? L - 1 : i - 1) >> DIGIT_BITS;
  return (f(i) & DIGIT_MASK) + (i == 0 ? -c : c);
}

// Digit i of carry_pass(v).
__device__ __forceinline__ int carry_digit(const int* v, int i, int L) {
  return carry_of([v](int x) { return v[x]; }, i, L);
}

// Digit i of shift_mod of the row whose digit x is f(x), s in [0, 2W): the
// sequence of limb.shift_mod's tensor path, formed on the fly at the two
// rotated source digits: s = (neg ? W : 0) + 16 kd + b, a rotation by kd
// (wrapped digits negated), the sub-digit shift by b (a carry pass at
// b == 0), the sign.
template <class F>
__device__ __forceinline__ int shift_of(F f, int i, long long s, int L) {
  const long long W = 16LL * L;
  const bool neg = s >= W;
  const long long r = neg ? s - W : s;
  const int kd = static_cast<int>(r >> 4);
  const int ip = i == 0 ? L - 1 : i - 1;
  const int vi = f(i >= kd ? i - kd : L - kd + i);
  const int vp = f(ip >= kd ? ip - kd : L - kd + ip);
  const int d = shift_bits_digit(i >= kd ? vi : -vi, ip >= kd ? vp : -vp, i,
                                 static_cast<int>(r & 15));
  return neg ? -d : d;
}

// Digit i of shift_mod(A + sgn * B, s), s in [0, 2W), sgn in {-1, 0, 1}
// (B unread at sgn 0).
__device__ __forceinline__ int shift_comb_digit(const int* A, const int* B, int sgn, int i,
                                                long long s, int L) {
  return shift_of([=](int x) { return sgn > 0 ? A[x] + B[x] : sgn < 0 ? A[x] - B[x] : A[x]; },
                  i, s, L);
}

// Digit i of shift_mod(v, s) with a per-row exponent s in [0, 2W): shift_of
// on v alone.
__device__ __forceinline__ int shift_mod_digit(const int* v, int i, long long s, int L) {
  return shift_comb_digit(v, nullptr, 0, i, s, L);
}

// Digit i of one radix-2 butterfly on the rows A, B (shared memory) with the
// stage twiddle 2^e, e in [0, 2W) -- the sequence of ops/butterfly.py as
// the ladder's plain version runs it:
//   fwd:  sa = a + b,          sb = (a - b) * 2^e      (rotate a - b)
//   inv:  u = b / 2^e = b * 2^(2W - e),  sa = a + u,  sb = a - u
// the twiddle a rotation by kd digits, the sub-digit shift by b, the sign.
__device__ __forceinline__ void butterfly_digit(const int* A, const int* B, int i, int L,
                                                long long e, bool inverse, int* sa, int* sb) {
  const long long W = 16LL * L;
  if (inverse) e = (2 * W - e) % (2 * W);
  const bool neg = e >= W;
  const int r = static_cast<int>(neg ? e - W : e);
  const int kd = r >> 4;
  const int ip = i == 0 ? L - 1 : i - 1;
  int r_i, r_p;
  if (!inverse) {
    const int si = i >= kd ? i - kd : L - kd + i;
    const int sp = ip >= kd ? ip - kd : L - kd + ip;
    r_i = (i >= kd ? 1 : -1) * (A[si] - B[si]);
    r_p = (ip >= kd ? 1 : -1) * (A[sp] - B[sp]);
  } else {
    r_i = rot_digit(B, i, kd, L);
    r_p = rot_digit(B, ip, kd, L);
  }
  int tw = shift_bits_digit(r_i, r_p, i, r & 15);
  if (neg) tw = -tw;
  if (!inverse) {
    *sa = A[i] + B[i];
    *sb = tw;
  } else {
    *sa = A[i] + tw;
    *sb = A[i] - tw;
  }
}

// (a * b) mod m for a, b >= 0 and m < 2^31.
__device__ __forceinline__ long long mulmod_small(long long a, long long b, long long m) {
  return (a % m) * (b % m) % m;
}

// Threads for a one-row-per-CTA kernel: L rounded up to a warp, at most cap.
inline unsigned row_threads(int L, int cap) {
  const int t = ((L + 31) / 32) * 32;
  return static_cast<unsigned>(t < cap ? t : cap);
}

inline cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mf
