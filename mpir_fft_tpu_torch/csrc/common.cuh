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

// Digit i of carry_pass(v): (v_i mod 2^16) + floor(v_{i-1} / 2^16), the top
// digit's carry wrapping to digit 0 negated (2^W == -1).
__device__ __forceinline__ int carry_digit(const int* v, int i, int L) {
  const int c = v[i == 0 ? L - 1 : i - 1] >> DIGIT_BITS;
  return (v[i] & DIGIT_MASK) + (i == 0 ? -c : c);
}

inline cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace mf
