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
// carry-free, then one carry_pass over the block.  A twiddle is the
// exponent decomposition e = (neg ? W : 0) + 16 kd + b: a negacyclic digit
// rotation by kd (direct indexing here; the TPU needed a barrel shifter),
// the sub-digit shift by b, the sign.
//
// What bounds it on an H100: device memory.  Each launch reads and writes
// the whole array once (8 bytes per digit); the twiddles are a few integer
// ops per digit on shared memory.  Design: one CTA holds the K ring
// elements of one h-position in shared memory, ping-ponging between two
// K*L buffers through the k stages, so the k stages cost one round trip.
// k is capped by that buffer (2*K*L*4 bytes, 64 KB at K=16, L=512) and by
// the deferred-carry growth ~2^(18+k) (fused.py:472-476): the wrapper picks
// k <= 4, far inside int32.
#include "common.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kThreads = 256;

struct Steps {
  long long s[kMaxStages];
};

__global__ void __launch_bounds__(kThreads)
ladder_kernel(const int* __restrict__ x, int* __restrict__ out, int K, int k,
              int h, int L, int inverse, Steps steps) {
  extern __shared__ int smem[];
  int* cur = smem;
  int* nxt = smem + K * L;
  const long long W = 16LL * L;
  const long long W2 = 2 * W;
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

  const int half = (K / 2) * L;
  for (int jj = 0; jj < k; ++jj) {
    const int j = inverse ? k - 1 - jj : jj;
    const int m = K >> (j + 1);
    const long long step = steps.s[j];
    for (int idx = threadIdx.x; idx < half; idx += blockDim.x) {
      const int p = idx / L;
      const int i = idx - p * L;
      const int qm = p % m;
      const int qa = (p / m) * 2 * m + qm;
      const int qb = qa + m;
      long long e = ((static_cast<long long>(qm) * h + hpos) * step) % W2;
      if (inverse) e = (W2 - e) % W2;            // divide: 2^(2W - e)
      const bool neg = e >= W;
      const int s = static_cast<int>(neg ? e - W : e);
      const int kd = s >> 4;
      const int b = s & 15;
      const int ip = i == 0 ? L - 1 : i - 1;
      const int* A = cur + qa * L;
      const int* B = cur + qb * L;
      int r_i, r_p;
      if (!inverse) {          // rotate (a - b)
        const int si = i >= kd ? i - kd : L - kd + i;
        const int sp = ip >= kd ? ip - kd : L - kd + ip;
        r_i = (i >= kd ? 1 : -1) * (A[si] - B[si]);
        r_p = (ip >= kd ? 1 : -1) * (A[sp] - B[sp]);
      } else {                 // rotate b
        r_i = mf::rot_digit(B, i, kd, L);
        r_p = mf::rot_digit(B, ip, kd, L);
      }
      int tw = mf::shift_bits_digit(r_i, r_p, i, b);
      if (neg) tw = -tw;
      if (!inverse) {
        nxt[qa * L + i] = A[i] + B[i];
        nxt[qb * L + i] = tw;
      } else {
        nxt[qa * L + i] = A[i] + tw;
        nxt[qb * L + i] = A[i] - tw;
      }
    }
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

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

MF_EXPORT int mf_ladder(const void* x, void* out, long long N, int K, int h, int L,
                        int inverse, const void* steps_host, int k, void* stream) {
  if (k < 1 || k > kMaxStages || K != (1 << k) || h < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = N * h;
  if (grid == 0) return 0;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  Steps st{};
  const long long* s = static_cast<const long long*>(steps_host);
  for (int j = 0; j < k; ++j) st.s[j] = s[j];
  const size_t smem = 2ull * K * L * sizeof(int);
  cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(ladder_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ladder_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), K, k, h, L, inverse, st);
  return static_cast<int>(cudaGetLastError());
}
