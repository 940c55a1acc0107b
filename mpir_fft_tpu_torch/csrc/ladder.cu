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
// 2^((e0 + j*step2)/2), half-bit exponents (the row body of the plain
// twiddle_half_rows_plain, run by run: mf::twiddle_half_run,
// ladder_group.cuh, shared with the whole-row transform and the standalone
// twiddle).
//
// What bounds it on an H100: shared-memory traffic and integer issue, then
// device memory.  Each launch moves 8 bytes per digit; each stage reads
// about 6 and writes 2 shared words per digit pair plus ~15 integer ops.
// Design (ladder_group.cuh): one CTA per h-position keeps its K rows in ONE
// K*L buffer and runs the k stages in place, each stage in rounds of whole
// pairs (read into registers, barrier, write); the twiddles are decomposed
// once per (stage, pair) into a table; digits move as int4 runs (L % 4 ==
// 0), the rotated reads as two aligned int4 windows.  The buffer is half the
// old ping-pong pair, so at the wrapper's budget (ops/fused.py
// LADDER_BUF_BYTES) three CTAs share an SM and one CTA's loads and stores
// overlap the others' stages.  The rows load with cp.async (16 bytes a
// thread, all of a CTA's copies in flight at once) and store as 16-byte
// vectors; the pre_half twiddle reads its rotated sources straight from
// device memory (L1) into the buffer, all K rows at once (aligned int4
// windows where L % 16 == 0).  k is capped at 4
// by the deferred-carry growth ~2^(18+k) (fused.py:472-476).
#include "ladder_group.cuh"

namespace {

template <int V, int P, int T>
__global__ void __launch_bounds__(T, T == 256 ? 3 : 1)
ladder_kernel(const int* __restrict__ x, int* __restrict__ out, int K, int k, int h, int L,
              int inverse, mf::LadderSteps steps, const int* __restrict__ pe, int pre,
              long long pre_e0, long long pre_step) {
  extern __shared__ int4 smem4[];
  int* buf = reinterpret_cast<int*>(smem4);
  int* tab0 = buf + K * L;
  int* tab1 = tab0 + k * (K / 2);
  int* pre_e = tab1 + k * (K / 2);
  const long long n = blockIdx.x / h;
  const int hpos = static_cast<int>(blockIdx.x % h);
  // row q of this CTA: x[n, q, hpos, :] at base + q * rstride
  const long long rstride = static_cast<long long>(h) * L;
  const long long base = n * K * rstride + static_cast<long long>(hpos) * L;
  mf::ladder_table(tab0, tab1, K, k, L, h, hpos, inverse != 0, steps,
                   pe == nullptr ? nullptr : pe + n * K);
  if (pre) {
    for (int q = threadIdx.x; q < K; q += T)
      pre_e[q] = mf::half_exp(static_cast<long long>(q) * h + hpos, pre_e0, pre_step, L);
    __syncthreads();
  }
  const int cpr = L / V;
  const int lg = (cpr & (cpr - 1)) ? -1 : __ffs(cpr) - 1;
  for (int idx = threadIdx.x; idx < K * cpr; idx += T) {
    const int q = lg >= 0 ? idx >> lg : idx / cpr;
    const int i0 = (idx - q * cpr) * V;
    const int* xr = x + base + q * rstride;
    int v[V];
    if (pre) {
      mf::twiddle_half_run<V>(xr, i0, pre_e[q], L, v);
    } else if constexpr (V == 4) {
      mf::cp_async16(buf + q * L + i0, xr + i0);   // every row chunk in flight at once
      continue;
    } else {
      mf::load_run<V>(xr + i0, v);
    }
    mf::store_run<V>(buf + q * L + i0, v);
  }
  if constexpr (V == 4) mf::cp_async_wait_all();
  __syncthreads();
  mf::ladder_group<V, P, T>(buf, K, k, L, inverse != 0, tab0, tab1, pe != nullptr, 0, k);
  // deferred carry: one sweep restores the ~2^17 inter-launch digit bound
  mf::carry_store<V, T>(buf, K, L, out, base, rstride);
}

template <int V, int P, int T>
int launch(const void* x, void* out, long long grid, int K, int k, int h, int L, int inverse,
           const mf::LadderSteps& st, const void* pe, int pre, long long pre_e0,
           long long pre_step, size_t smem, void* stream) {
  const auto kernel = ladder_kernel<V, P, T>;
  cudaError_t err = mf::prepare_group_kernel(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(grid), T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), K, k, h, L, inverse, st,
      static_cast<const int*>(pe), pre, pre_e0, pre_step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

MF_EXPORT const char* mf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pe: null, or (N, K/2, 2) int32 exponents in [0, 2W) for the innermost
// stage (h must be 1).  pre: 1 for the pre_half twiddle (forward only),
// with pre_e0, pre_step in [0, 4W).  Runs of 4 digits where L % 4 == 0 and
// x, out are 16-byte aligned, else of one; either way rows of at most
// 8192 digits (one pair a round).  Which K and L launch is the wrapper's
// rule (ops/fused.py ladder_fits).
MF_EXPORT int mf_ladder(const void* x, void* out, long long N, int K, int h, int L,
                        int inverse, const void* steps_host, int k, const void* pe, int pre,
                        long long pre_e0, long long pre_step, void* stream) {
  if (k < 1 || k > mf::kMaxLadderStages || K != (1 << k) || h < 1 || L < 1 ||
      (pe != nullptr && h != 1) || (pre && inverse))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mf::ladder_smem_bytes(K, k, L);
  const long long grid = N * h;
  if (grid == 0) return 0;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  mf::LadderSteps st{};
  const long long* s = static_cast<const long long*>(steps_host);
  for (int j = 0; j < k; ++j) st.s[j] = s[j];
  const bool vec = L % 4 == 0 &&
                   (reinterpret_cast<unsigned long long>(x) |
                    reinterpret_cast<unsigned long long>(out)) % 16 == 0;
  if (vec) {
    const int T = mf::group_threads(L / 4, 4, 512);
    if (T == 256)
      return launch<4, 4, 256>(x, out, grid, K, k, h, L, inverse, st, pe, pre, pre_e0, pre_step,
                               smem, stream);
    if (T == 512)
      return launch<4, 4, 512>(x, out, grid, K, k, h, L, inverse, st, pe, pre, pre_e0, pre_step,
                               smem, stream);
  } else {
    const int T = mf::group_threads(L, 8, 1024);
    if (T == 256)
      return launch<1, 8, 256>(x, out, grid, K, k, h, L, inverse, st, pe, pre, pre_e0, pre_step,
                               smem, stream);
    if (T == 1024)
      return launch<1, 8, 1024>(x, out, grid, K, k, h, L, inverse, st, pe, pre, pre_e0, pre_step,
                                smem, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
