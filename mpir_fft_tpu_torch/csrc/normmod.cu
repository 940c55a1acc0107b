// Exact canonicalization of ring elements, with a static power-of-two shift:
// out = normmod(x * 2^s mod 2^(16L)+1) for every row.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_rows (fused.py:503) as used by
// limb.normmod_div (limb.py:214-230): the inverse transform's divide by
// 2^lg_conv + normalize tail (s = 2W - lg_conv); s = 0 is plain normmod.
// Plain version: ops/fused.py normmod_rows_plain.  The output is canonical,
// so it equals the JAX result bit for bit.
//
// Per row: the static shift (negacyclic rotation by kd digits, sub-digit
// shift by b when b != 0, sign), two carry passes (digits now in
// [-1, 2^16]), then the exact carry: each digit's carry transition
// f(cin) = floor((d + cin) / 2^16) maps {-1,0,1} to {-1,0,1}; an inclusive
// scan composes them (packed 2 bits per input value), cin_i is the prefix
// before i evaluated at 0, and the row's carry-out c folds back in at digit
// 0 as -c (2^W == -1) with a ripple that keeps the -1 form [-1, 0, ...]
// (limb.py:28-32, 258-287).
//
// What bounds it on an H100: device memory -- one read and one write of the
// row (8 bytes per digit) against ~30 shared-memory steps per digit.
// Design: one CTA per row, the row in shared memory through every phase; the
// carry scan is a Hillis-Steele scan over the L transitions (log2 L steps),
// the ripple a block-wide min-reduction of the first non-propagating digit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
normmod_kernel(const int* __restrict__ x, int* __restrict__ out, int L, int kd, int b,
               int neg) {
  extern __shared__ int sm[];
  int* A = sm;
  int* B = sm + L;
  int* C = sm + 2 * L;
  __shared__ int first;
  const long long row = blockIdx.x;
  const int* xr = x + row * L;

  for (int i = threadIdx.x; i < L; i += blockDim.x) A[i] = xr[i];
  __syncthreads();

  // static shift: rotate, sub-digit shift if b, sign
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    int v = mf::rot_digit(A, i, kd, L);
    if (b) v = mf::shift_bits_digit(v, mf::rot_digit(A, i == 0 ? L - 1 : i - 1, kd, L), i, b);
    B[i] = neg ? -v : v;
  }
  __syncthreads();
  // two carry passes bound the digits into the scan's range [-1, 2^16]
  for (int i = threadIdx.x; i < L; i += blockDim.x) A[i] = mf::carry_digit(B, i, L);
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x) B[i] = mf::carry_digit(A, i, L);
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
    dst[i] = (B[i] + cin) & mf::DIGIT_MASK;
  }
  if (threadIdx.x == 0) first = L;
  __syncthreads();

  // value == r - cout (mod p): +1 ripples through 0xffff digits (cout == -1),
  // -1 through zero digits (cout == +1); all of them -> the -1 form
  if (cout != 0) {
    const int prop = cout == -1 ? mf::DIGIT_MASK : 0;
    for (int i = threadIdx.x; i < L; i += blockDim.x)
      if (dst[i] != prop) atomicMin(&first, i);
  }
  __syncthreads();
  const int f = first;
  int* outr = out + row * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int v = dst[i];
    int o;
    if (cout == 0) o = v;
    else if (f == L) o = i == 0 ? -1 : 0;
    else if (cout == -1) o = i < f ? 0 : (i == f ? v + 1 : v);
    else o = i < f ? mf::DIGIT_MASK : (i == f ? v - 1 : v);
    outr[i] = o;
  }
}

}  // namespace

MF_EXPORT int mf_normmod(const void* x, void* out, long long B, int L, int s, void* stream) {
  const long long W = 16LL * L;
  if (L < 1 || s < 0 || s >= 2 * W) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int neg = s >= W;
  const int r = static_cast<int>(neg ? s - W : s);
  const size_t smem = 3ull * L * sizeof(int);
  cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(normmod_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  normmod_kernel<<<static_cast<unsigned>(B), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), L, r >> 4, r & 15, neg);
  return static_cast<int>(cudaGetLastError());
}
