// A whole radix-2 transform of each (C, L) batch row in one launch, the row
// resident in shared memory through all log2(C) stages.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_batched (fused.py:171-197,
// pallas_call :187) as ops/transforms.py uses it for fft_radix2 /
// ifft_radix2 (transforms.py:128-135, 279-286): the recursive mulmod's inner
// negacyclic transforms, and every batched transform whose row is small.
// Plain version: ops/fused.py transform_plain (the ladder groups), whose
// integer sequence this kernel repeats, so the digits agree exactly.
//
// Stage s (forward s = 0..D-1, inverse s = D-1..0) pairs positions
// (qa, qa + half), half = C >> (s+1), with twiddle exponent e = (qa mod half)
// * (w << s) mod 2W:  fwd s = a + b, t = (a - b) 2^e;  inv u = b / 2^e,
// a' = a + u, b' = a - u (mf::butterfly_digit, shared with csrc/mfa_cols.cu; the
// ladder runs the same digit expressions, csrc/ladder_group.cuh).  The stages
// run in the groups of ops/fused.py ladder_groups (at most kmax stages
// each), with one carry pass after every group: the deferred-carry growth
// ~2^(18+k) of fused.py:472-476 stays inside int32 and the carries fall
// where the ladder launches put them.
//
// What bounds it on an H100: device memory -- one read and one write of the
// row per transform, against ~log2(C) shared-memory sweeps.  Design: one CTA
// per row, ping-ponging between two C*L buffers (the wrapper keeps 2*C*L*4
// bytes within its shared-memory budget).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void stage(const int* cur, int* nxt, int C, int L, int s, long long w,
                                      int inverse) {
  const long long W2 = 32LL * L;
  const int half = C >> (s + 1);
  const long long step = w << s;
  const int pairs = (C / 2) * L;
  for (int idx = threadIdx.x; idx < pairs; idx += blockDim.x) {
    const int p = idx / L;
    const int i = idx - p * L;
    const int pos = p % half;
    const int qa = (p / half) * 2 * half + pos;
    const int qb = qa + half;
    mf::butterfly_digit(cur + qa * L, cur + qb * L, i, L, (pos * step) % W2, inverse,
                        nxt + qa * L + i, nxt + qb * L + i);
  }
}

__global__ void __launch_bounds__(kThreads)
transform_small_kernel(const int* __restrict__ x, int* __restrict__ out, int C, int D, int L,
                       long long w, int inverse, int kmax) {
  extern __shared__ int smem[];
  int* cur = smem;
  int* nxt = smem + C * L;
  const int CL = C * L;
  const long long base = static_cast<long long>(blockIdx.x) * CL;
  for (int idx = threadIdx.x; idx < CL; idx += blockDim.x) cur[idx] = x[base + idx];
  __syncthreads();

  // groups in ladder_groups order: forward from stage 0 up, inverse from
  // the top group down, each group's stages then one carry pass
  int done = 0;
  while (done < D) {
    const int kg = min(kmax, D - done);
    const int lo = inverse ? D - done - kg : done;
    for (int jj = 0; jj < kg; ++jj) {
      const int s = inverse ? lo + kg - 1 - jj : lo + jj;
      stage(cur, nxt, C, L, s, w, inverse);
      __syncthreads();
      int* t = cur;
      cur = nxt;
      nxt = t;
    }
    for (int idx = threadIdx.x; idx < CL; idx += blockDim.x) {
      const int q = idx / L;
      nxt[idx] = mf::carry_digit(cur + q * L, idx - q * L, L);
    }
    __syncthreads();
    int* t = cur;
    cur = nxt;
    nxt = t;
    done += kg;
  }
  for (int idx = threadIdx.x; idx < CL; idx += blockDim.x) out[base + idx] = cur[idx];
}

}  // namespace

// x, out: (B, C, L) int32, C = 2^D >= 2; w: the root exponent (z = 2^w);
// kmax: stages per carry group.
MF_EXPORT int mf_transform_small(const void* x, void* out, long long B, int C, int L,
                                 long long w, int inverse, int kmax, void* stream) {
  if (C < 2 || (C & (C - 1)) || L < 1 || kmax < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int D = 0;
  while ((1 << D) < C) ++D;
  const size_t smem = 2ull * C * L * sizeof(int);
  cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(transform_small_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  transform_small_kernel<<<static_cast<unsigned>(B), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), C, D, L, w, inverse, kmax);
  return static_cast<int>(cudaGetLastError());
}
