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
// 2^((e0 + j*step2)/2), half-bit exponents (the row body of
// mf::twiddle_half_row, digit by digit).
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

// Digit j of the odd half-bit twiddle's pre-carry row t2 = hi - lo of the
// row x (mf::twiddle_half_row): hi, lo the static rotations by 3L/4 and L/4
// digits of base = shift_mod(x, k) when L % 4 == 0, else the two sub-digit
// shift_mods of x.
__device__ __forceinline__ int half_t2(const int* x, int j, long long k, int L) {
  if (L % 4 == 0) {
    const int kh = 3 * L / 4, kl = L / 4;
    const int hi = j >= kh ? mf::shift_mod_digit(x, j - kh, k, L)
                           : -mf::shift_mod_digit(x, L - kh + j, k, L);
    const int lo = j >= kl ? mf::shift_mod_digit(x, j - kl, k, L)
                           : -mf::shift_mod_digit(x, L - kl + j, k, L);
    return hi - lo;
  }
  const long long W = 16LL * L;
  return mf::shift_mod_digit(x, j, (k + 3 * W / 4) % (2 * W), L) -
         mf::shift_mod_digit(x, j, (k + W / 4) % (2 * W), L);
}

// r[t] = rot_digit(base, i0 - 1 + t, kdig) for t = 0..4 (i0 - 1 = L - 1 at
// i0 == 0), base = shift_mod(x, k), for i0 and kdig multiples of 4: the
// rotated run as one aligned 4-digit twist and the digit below it.
__device__ __forceinline__ void rot_base_run(const int* x, int i0, int kdig, int k, int L,
                                             int (&r)[5]) {
  int p0 = i0 - kdig;
  if (p0 < 0) p0 += L;
  int b4[4];
  mf::twist<4, 0>(x, nullptr, p0, k, L, b4);
  const int bm = mf::shift_mod_digit(x, p0 == 0 ? L - 1 : p0 - 1, k, L);
  r[0] = (i0 == 0 ? L - 1 : i0 - 1) >= kdig ? bm : -bm;
#pragma unroll
  for (int t = 0; t < 4; ++t) r[t + 1] = i0 >= kdig ? b4[t] : -b4[t];
}

// Digits i0 .. i0+V-1 of x * 2^(e2/2) (one row, global memory), e2 in
// [0, 4W): shift_mod(x, e2/2) for even e2, else carry_pass(t2).
template <int V>
__device__ __forceinline__ void twiddle_half_run(const int* x, int i0, int e2, int L,
                                                 int (&v)[V]) {
  const long long k = e2 >> 1;
  if (!(e2 & 1)) {
    mf::twist<V, 0>(x, nullptr, i0, static_cast<int>(k), L, v);
    return;
  }
  if constexpr (V == 4) {
    if (L % 16 == 0) {        // the static rotations 3L/4, L/4 keep runs aligned
      int hi[5], lo[5];
      rot_base_run(x, i0, 3 * L / 4, static_cast<int>(k), L, hi);
      rot_base_run(x, i0, L / 4, static_cast<int>(k), L, lo);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = (hi[t] - lo[t]) >> mf::DIGIT_BITS;
        v[t] = ((hi[t + 1] - lo[t + 1]) & mf::DIGIT_MASK) + (i0 + t == 0 ? -c : c);
      }
      return;
    }
  }
  int prev = half_t2(x, i0 == 0 ? L - 1 : i0 - 1, k, L);
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int cur = half_t2(x, i0 + t, k, L);
    const int c = prev >> mf::DIGIT_BITS;
    v[t] = (cur & mf::DIGIT_MASK) + (i0 + t == 0 ? -c : c);
    prev = cur;
  }
}

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
    const long long M4 = 64LL * L;  // 4W
    for (int q = threadIdx.x; q < K; q += T)
      pre_e[q] = static_cast<int>(
          (pre_e0 + mf::mulmod_small(static_cast<long long>(q) * h + hpos, pre_step, M4)) % M4);
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
      twiddle_half_run<V>(xr, i0, pre_e[q], L, v);
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
  mf::ladder_group<V, P, T>(buf, K, k, L, inverse != 0, tab0, tab1, pe != nullptr);
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
