// Butterfly ladder: k consecutive radix-2 FFT stages over Z/(2^W+1)Z in one
// pass over the coefficient array.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_butterfly_ladder (the Pallas
// ladder; fused.py:250).  Plain version: ops/fused.py ladder_plain, which
// runs the same integer sequence, so the digits agree exactly.
//
// Input/output (N, K, h, L) int32 redundant digits, W = 16 L, K = 2^k.  Each
// batch row n holds one length-K*h DIF block group; stage j pairs K-indices
// (q, q+m), m = K >> (j+1), with twiddle 2^e, e = (qm*h + hpos) * steps[j]:
//   fwd (j = 0..k-1):  s = a + b,            t = (a - b) * 2^e
//   inv (j = k-1..0):  u = b / 2^e,  a' = a + u,  b' = a - u
// carry-free, then one carry_pass over the block.  With a table pe (N, K/2,
// 2) int32 (only for h == 1, a group ending at the transform's last stage:
// the MFA's cross twiddles, fused.py:268-273, :430-432), the innermost stage
// (m == 1) also takes pair p's exponents pe0, pe1:
//   fwd:  s = (a + b) * 2^pe0,   t = (a - b) * 2^(e + pe1)
//   inv:  a' = a / 2^pe0,  u = b / 2^(e + pe1),  a' + u,  a' - u
// With pre_half = (e0, step2) (forward, the first group of a transform:
// the zero-top staged forward's t-leg, fused.py:275, :384, :416-417), each
// loaded row at transform position j = q*h + hpos is first multiplied by
// 2^((e0 + j*step2)/2), half-bit exponents (mf::twiddle_half_row, the
// routine of the top-layer kernels).
// A twiddle is the exponent decomposition e = (neg ? W : 0) + 16 kd + b: a
// negacyclic digit rotation by kd (direct indexing here; the TPU needed a
// barrel shifter), the sub-digit shift by b, the sign.
//
// What bounds it on an H100: device memory.  Each launch reads and writes
// the whole array once (8 bytes per digit); the twiddles are a few integer
// ops per digit on shared memory.  Design: one CTA holds the K ring
// elements of one h-position in shared memory, ping-ponging between two
// K*L buffers through the k stages (mf::ladder_group), so the k stages cost
// one round trip.  k is capped by that buffer (2*K*L*4 bytes, 64 KB at
// K=16, L=512) and by the deferred-carry growth ~2^(18+k) (fused.py:472-476):
// the wrapper picks k <= 4, far inside int32.  The pre_half twiddle runs
// row by row before stage 0 with the idle nxt buffer as its two scratch
// rows, so it needs no shared memory of its own.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ladder_kernel(const int* __restrict__ x, int* __restrict__ out, int K, int k, int h, int L,
              int inverse, mf::LadderSteps steps, const int* __restrict__ pe, int pre,
              long long pre_e0, long long pre_step) {
  extern __shared__ int smem[];
  int* cur = smem;
  int* nxt = smem + K * L;
  const long long n = blockIdx.x / h;
  const int hpos = static_cast<int>(blockIdx.x % h);
  const int KL = K * L;
  // row q of this CTA: xp[n, q, hpos, :]
  auto gidx = [&](int q, int i) { return ((n * K + q) * h + hpos) * static_cast<long long>(L) + i; };

  for (int idx = threadIdx.x; idx < KL; idx += blockDim.x) {
    const int q = idx / L;
    cur[idx] = x[gidx(q, idx - q * L)];
  }
  __syncthreads();

  if (pre) {
    const long long M4 = 64LL * L;  // 4W
    for (int q = 0; q < K; ++q) {
      const long long e2 = (pre_e0 + mf::mulmod_small(static_cast<long long>(q) * h + hpos,
                                                      pre_step, M4)) % M4;
      mf::twiddle_half_row(cur + q * L, nxt, nxt + L, nxt, e2, L);
      for (int i = threadIdx.x; i < L; i += blockDim.x) cur[q * L + i] = nxt[i];
      __syncthreads();
    }
  }

  cur = mf::ladder_group(cur, nxt, K, k, L, h, hpos, inverse != 0, steps,
                         pe == nullptr ? nullptr : pe + n * K);

  // deferred carry: one sweep restores the ~2^17 inter-launch digit bound
  for (int idx = threadIdx.x; idx < KL; idx += blockDim.x) {
    const int q = idx / L;
    const int i = idx - q * L;
    out[gidx(q, i)] = mf::carry_digit(cur + q * L, i, L);
  }
}

}  // namespace

MF_EXPORT const char* mf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pe: null, or (N, K/2, 2) int32 exponents in [0, 2W) for the innermost
// stage (h must be 1).  pre: 1 for the pre_half twiddle (forward only),
// with pre_e0, pre_step in [0, 4W).
MF_EXPORT int mf_ladder(const void* x, void* out, long long N, int K, int h, int L,
                        int inverse, const void* steps_host, int k, const void* pe, int pre,
                        long long pre_e0, long long pre_step, void* stream) {
  if (k < 1 || k > mf::kMaxLadderStages || K != (1 << k) || h < 1 || L < 1 ||
      (pe != nullptr && h != 1) || (pre && inverse))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = N * h;
  if (grid == 0) return 0;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  mf::LadderSteps st{};
  const long long* s = static_cast<const long long*>(steps_host);
  for (int j = 0; j < k; ++j) st.s[j] = s[j];
  const size_t smem = 2ull * K * L * sizeof(int);
  cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(ladder_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ladder_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), K, k, h, L, inverse, st,
      static_cast<const int*>(pe), pre, pre_e0, pre_step);
  return static_cast<int>(cudaGetLastError());
}
