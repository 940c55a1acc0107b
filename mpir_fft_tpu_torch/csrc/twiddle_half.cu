// Half-bit twiddle of ring-element rows: out[r] = x[r] * 2^(e2_r / 2) mod
// 2^(16L)+1 with the affine exponent e2_r = (e0 + (r mod h) * step) mod 4W.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_twiddle_half (fused.py:533-572,
// pallas_call :562), whose body is _twiddle_half_rows (:714-736).  Plain
// version: ops/fused.py twiddle_half_rows_plain, the same integer sequence,
// so the digits agree exactly.  On the port's main path it weights the
// recursive mulmod's negacyclic transforms (ops/negacyclic.py: step w' in
// the forward, -w' in the inverse); the sqrt2 top layer runs the same row
// body inside its own kernels (csrc/sqrt2_top.cu).
//
// Per row: even e2 is a plain shift_mod by k = e2/2; odd e2 is the sqrt2
// shift carry_pass(hi - lo), 2^(k+1/2) = 2^(k+3W/4) - 2^(k+W/4)
// (mf::twiddle_half_row, common.cuh).
//
// What bounds it on an H100: device memory -- one read and one write of the
// row.  Design: one CTA per row with the row in shared memory (the rotations
// index it directly; the TPU needed a barrel shifter), threads = L rounded
// up to a warp (at most 256), so the narrow inner rings (L = 32) do not idle
// seven warps of eight.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
twiddle_half_kernel(const int* __restrict__ x, int* __restrict__ out, int L, long long h,
                    long long e0, long long step) {
  extern __shared__ int sm[];
  int* X = sm;
  int* T1 = sm + L;
  int* T2 = sm + 2 * L;
  const long long row = blockIdx.x;
  const long long M4 = 64LL * L;  // 4W
  const long long e2 = (e0 + mf::mulmod_small(row % h, step, M4)) % M4;
  const int* xr = x + row * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) X[i] = xr[i];
  __syncthreads();
  mf::twiddle_half_row(X, T1, T2, out + row * L, e2, L);
}

}  // namespace

// x, out: (B, L) int32; row r takes j = r mod h.  e0 and step are reduced
// mod 4W here (step may be negative).
MF_EXPORT int mf_twiddle_half(const void* x, void* out, long long B, int L, long long h,
                              long long e0, long long step, void* stream) {
  if (L < 1 || h < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long M4 = 64LL * L;
  e0 = ((e0 % M4) + M4) % M4;
  step = ((step % M4) + M4) % M4;
  const size_t smem = 3ull * L * sizeof(int);
  cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(twiddle_half_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  twiddle_half_kernel<<<static_cast<unsigned>(B), mf::row_threads(L, kMaxThreads), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), L, h, e0, step);
  return static_cast<int>(cudaGetLastError());
}
