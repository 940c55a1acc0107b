// The sqrt2 top layer of the length-4n transforms for odd w, forward and
// inverse, each one pass over the coefficient array.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_sqrt2_top_fwd (fused.py:739-780,
// pallas_call :772) and fused_sqrt2_top_inv (fused.py:783-834, pallas_call
// :826).  Plain versions: ops/fused.py sqrt2_top_fwd_plain and
// sqrt2_top_inv_plain, the same integer sequence, so the digits agree
// exactly.
//
// Layout: input and output are the whole [N, C, L] array, C = 2h; row j of
// the first half pairs with row j of the second.  q^j = 2^(j w / 2) (half-bit
// exponent j w; q = sqrt2^w is the 4n-th root):
//   fwd:  out[:, j] = carry_pass(a_j + b_j),  out[:, h + j] = (a_j - b_j) q^j
//   inv:  u = oR_j q^-j,  out[:, j] = post(sL_j + u),  out[:, h + j] =
//         post(sL_j - u),  post = carry_pass, or with a norm shift s the
//         canonicalization normmod(v * 2^s) (the drivers' divide by
//         2^lg_conv + normalize tail, s = 2W - lg_conv) -- the block-row
//         body of csrc/normmod.cu (mf::normmod_row: 8 digits a thread, O(L)
//         work), so no second launch.
// Reading the halves by row index keeps the stacked operands' [2, C, L]
// array whole: no copy of a non-contiguous half, and the two half
// transforms then run as one transform over [N, 2, h, L].
//
// What bounds it on an H100: device memory -- one read and one write of the
// array.  Design: one CTA per row pair, both rows in shared memory; the
// twiddle is mf::twiddle_half_row (common.cuh), the rotations direct
// indexing.
#include "normmod_row.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTailMaxThreads = 1024;   // the norm tail's block rows, L <= 8192

__device__ __forceinline__ long long top_exp(long long j, long long w, int L, bool inverse) {
  const long long M4 = 64LL * L;  // 4W
  const long long e = mf::mulmod_small(j, w, M4);
  return inverse ? (M4 - e) % M4 : e;
}

__global__ void __launch_bounds__(kMaxThreads)
sqrt2_top_fwd_kernel(const int* __restrict__ x, int* __restrict__ out, long long h, int L,
                     long long w) {
  extern __shared__ int sm[];
  int* D = sm;           // a - b
  int* T1 = sm + L;      // a + b, then twiddle scratch
  int* T2 = sm + 2 * L;
  const long long n = blockIdx.x / h;
  const long long j = blockIdx.x % h;
  const long long ra = (n * 2 * h + j) * L;
  const long long rb = ra + h * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int a = x[ra + i], b = x[rb + i];
    T1[i] = a + b;
    D[i] = a - b;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L; i += blockDim.x) out[ra + i] = mf::carry_digit(T1, i, L);
  __syncthreads();
  mf::twiddle_half_row(D, T1, T2, out + rb, top_exp(j, w, L, false), L);
}

// V 0: a carry pass only; V 4 / 1: the norm tail, a block row
// (mf::normmod_row in csrc/normmod.cu's layout) with runs of V digits.
template <int V>
__global__ void __launch_bounds__(V == 0 ? kMaxThreads : kTailMaxThreads)
sqrt2_top_inv_kernel(const int* __restrict__ x, int* __restrict__ out, long long h, int L,
                     long long w, int s) {
  extern __shared__ int sm[];
  int* S = sm;           // sL
  int* O = sm + L;       // oR, then scratch
  int* U = sm + 2 * L;   // u = oR q^-j
  int* T2 = sm + 3 * L;
  int* A = sm + 4 * L;
  const long long n = blockIdx.x / h;
  const long long j = blockIdx.x % h;
  const long long ra = (n * 2 * h + j) * L;
  const long long rb = ra + h * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    S[i] = x[ra + i];
    O[i] = x[rb + i];
  }
  __syncthreads();
  mf::twiddle_half_row(O, U, T2, U, top_exp(j, w, L, true), L);
  if constexpr (V > 0) {
    for (int i = threadIdx.x; i < L; i += blockDim.x) A[i] = S[i] + U[i];
    __syncthreads();
    mf::normmod_row<V, mf::kBlockDigits / V>(A, L, s, out + ra);
    for (int i = threadIdx.x; i < L; i += blockDim.x) A[i] = S[i] - U[i];
    __syncthreads();
    mf::normmod_row<V, mf::kBlockDigits / V>(A, L, s, out + rb);
  } else {
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      A[i] = S[i] + U[i];
      O[i] = S[i] - U[i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      out[ra + i] = mf::carry_digit(A, i, L);
      out[rb + i] = mf::carry_digit(O, i, L);
    }
  }
}

template <int V>
int launch_inv(const void* x, void* out, long long grid, long long h, int L, long long w, int s,
               unsigned threads, cudaStream_t stream) {
  const size_t smem = 5ull * L * sizeof(int);
  const cudaError_t err =
      mf::set_smem(reinterpret_cast<const void*>(sqrt2_top_inv_kernel<V>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sqrt2_top_inv_kernel<V><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      static_cast<const int*>(x), static_cast<int*>(out), h, L, w, s);
  return static_cast<int>(cudaGetLastError());
}

cudaError_t launch_check(long long N, long long h, int L, long long* grid) {
  if (L < 1 || h < 1 || N < 0) return cudaErrorInvalidValue;
  *grid = N * h;
  if (*grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace

// x, out: (N, 2h, L) int32; w: the transform's odd root exponent.
MF_EXPORT int mf_sqrt2_top_fwd(const void* x, void* out, long long N, long long h, int L,
                               long long w, void* stream) {
  long long grid = 0;
  cudaError_t err = launch_check(N, h, L, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid == 0) return 0;
  const size_t smem = 3ull * L * sizeof(int);
  err = mf::set_smem(reinterpret_cast<const void*>(sqrt2_top_fwd_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sqrt2_top_fwd_kernel<<<static_cast<unsigned>(grid), mf::row_threads(L, kMaxThreads), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), h, L, w);
  return static_cast<int>(cudaGetLastError());
}

// s: the norm tail's shift exponent in [0, 2W), or -1 for a carry pass only.
MF_EXPORT int mf_sqrt2_top_inv(const void* x, void* out, long long N, long long h, int L,
                               long long w, int s, void* stream) {
  long long grid = 0;
  cudaError_t err = launch_check(N, h, L, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long W = 16LL * L;
  if (s < -1 || s >= 2 * W) return static_cast<int>(cudaErrorInvalidValue);
  if (grid == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned threads = mf::row_threads(L, kMaxThreads);
  if (s < 0) return launch_inv<0>(x, out, grid, h, L, w, s, threads, st);
  // the norm tail: at least the block rows' threads (csrc/normmod.cu's
  // layout); its rows are read from shared memory and written to out
  const unsigned bt = static_cast<unsigned>(mf::block_row_threads(L));
  if (bt > kTailMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tt = bt > threads ? bt : threads;
  return mf::run_width(L, out, out) == 4 ? launch_inv<4>(x, out, grid, h, L, w, s, tt, st)
                                         : launch_inv<1>(x, out, grid, h, L, w, s, tt, st);
}
