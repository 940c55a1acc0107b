// Link kernels of the NTT-CRT pointwise product mod 2^(16M)+1 (ops/ntt.py
// mulmod_ntt): the dense tier's elementwise chains between its int8 GEMMs,
// each one pass over device memory, and Garner's CRT for both tiers.
//
// Replaces: mpir_fft_tpu/ops/ntt.py
//   input_planes     <- _input_planes (ntt.py:698, pallas_call :719)
//   mid_planes       <- _mid_planes   (ntt.py:730, pallas_call :749)
//   garner_carry     <- _garner_carry (ntt.py:465, pallas_call :527), raw_k = 2
//   garner_residues  <- _garner_carry (ntt.py:465, pallas_call :527), raw_k = None
//                       (the 4-step tier's three residue rows)
// Plain versions: ops/ntt.py input_planes_plain, mid_planes_plain,
// garner_carry_plain, garner_residues_plain -- the same integer sequences,
// so the outputs agree digit for digit (and input_planes / mid_planes bit
// for bit with the reference's kernels: their outputs are functions of
// exact residues).
//
// Dense tier (input_planes, mid_planes, garner_carry): the primes 12289,
// 40961, 61441 (== 1 mod 4096, M <= 2048), two signed-int8 planes per
// value, lo at column i and hi at column M + i.  mid_planes also serves the
// pair tier (ntt_pair.cu) on its rows of M pairs at its two other primes,
// 18433 and 59393 (== 1 mod 2048, M <= 1024; the centered product below
// (p/2)^2 < 2^30 as for the tier-1 primes).  garner_residues takes the
// 4-step tier's primes 65537, 114689, 163841 (M = 4096, 8192).  Each kernel
// is templated on its prime(s) (ntt_common.cuh).
//
// What bounds them on an H100: device memory.  Per digit, input_planes
// reads 4 bytes and writes 3 x 2; mid_planes reads 2 x 8 and writes 2;
// garner_carry reads 3 x 8 and writes 4, garner_residues 3 x 4 and 4.
// Design: input_planes and mid_planes take four digits per thread (16-byte
// loads, 4-byte stores of four int8 planes), a grid-stride loop over all
// rows; the Garner kernels are row-local (digit i takes pieces of
// coefficients i, i-1, i-2, then a carry from digit i-1), so one CTA per
// row keeps the row's coefficients in shared memory (12 M bytes: int64
// coefficients and int32 digit sums; 96 KB at M = 8192, above the default
// 48 KB, so that launch raises the kernel's dynamic shared-memory limit).
//
// The garner_post epilogue (ntt.py:445-462, read at :493): both Garner
// forms also take a post leg (K = 2^k, the k stage exponents), the staged
// flagship's innermost inverse ladder group.  One CTA then owns K
// consecutive rows.  Its threads run Garner + spread + carry on all K rows
// at once, each on runs of 8 digits: a run recomputes the three
// coefficients below it (11 per 8 digits) instead of keeping a row of them,
// so the digits go straight into the K*M buffer with no scratch and no
// barrier between rows.  Then the k inverse stages run in place on the
// buffer (mf::ladder_group, ladder_group.cuh: the ladder's routine, the same
// twiddles, carry-free stages, then one carry pass) and the rows are
// written once.  Shared memory: the K*M buffer and the twiddle tables
// (mf::ladder_smem_bytes), 64 KB at the staged shapes (M 1024 K 16, M 2048
// K 8, M 4096 K 4), so three CTAs share an SM.  The spectrum chunk's first
// inverse leg costs no round trip of its own.
#include "ladder_group.cuh"
#include "ntt_common.cuh"

namespace {

using mf::fold;
using mf::mod_center;
using mf::mod_nonneg;
using mf::planes_of;

constexpr int kP1 = 12289, kP2 = 40961, kP3 = 61441;
// the pair tier's other two primes (ops/ntt.py PRIMES_PAIR: 12289, 18433,
// 40961, 59393, 61441), for mid_planes
constexpr int kPairP2 = 18433, kPairP4 = 59393;
constexpr int kMaxM = 2048;

// The prime triples and their Garner constants: p1^-1 mod p2, p1^-1 mod
// p3, p2^-1 mod p3.
struct Tier1 {
  static constexpr int P1 = kP1, P2 = kP2, P3 = kP3;
  static constexpr int Inv12 = 5853, Inv13 = 46082, Inv23 = 3;
};
struct Tier2 {
  static constexpr int P1 = 65537, P2 = 114689, P3 = 163841;
  static constexpr int Inv12 = 38232, Inv13 = 109229, Inv23 = 54617;
};
template <class T>
constexpr bool garner_ok() {
  return static_cast<long long>(T::P1) * T::Inv12 % T::P2 == 1 &&
         static_cast<long long>(T::P1) * T::Inv13 % T::P3 == 1 &&
         static_cast<long long>(T::P2) * T::Inv23 % T::P3 == 1;
}
static_assert(garner_ok<Tier1>(), "tier-1 Garner constants");
static_assert(garner_ok<Tier2>(), "tier-2 Garner constants");

constexpr int kThreads = 256;

// x (B, M) int32 digits -> out (3, B, 2M) int8: the balanced carry pass
// (m_j = (x_j + 2^15) >> 16; xb_i = x_i - 2^16 m_i + m_(i-1), the top
// carry wrapping negated into digit 0), then per prime the planes of the
// centered residue of xb.
__global__ void __launch_bounds__(kThreads)
input_planes_kernel(const int* __restrict__ x, signed char* __restrict__ out, long long B,
                    int M) {
  const int per_row = M / 4;
  const long long groups = B * per_row;
  const long long slab = B * 2LL * M;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; g < groups;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = g / per_row;
    const int i0 = static_cast<int>(g - row * per_row) * 4;
    const int* xr = x + row * M;
    const int4 v4 = *reinterpret_cast<const int4*>(xr + i0);
    const int v[4] = {v4.x, v4.y, v4.z, v4.w};
    int m_prev = (xr[i0 == 0 ? M - 1 : i0 - 1] + (1 << 15)) >> mf::DIGIT_BITS;
    if (i0 == 0) m_prev = -m_prev;
    int xb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = (v[j] + (1 << 15)) >> mf::DIGIT_BITS;
      xb[j] = v[j] - mf::shl(m, mf::DIGIT_BITS) + m_prev;
      m_prev = m;
    }
    signed char* o = out + row * 2LL * M + i0;
    planes_of<kP1>(xb, o, o + M);
    planes_of<kP2>(xb, o + slab, o + slab + M);
    planes_of<kP3>(xb, o + 2 * slab, o + 2 * slab + M);
  }
}

// sa, sb (B, 2M) int32 raw forward sums -> out (B, 2M) int8: both folded
// and centered, multiplied mod P, the product's planes.
template <int P>
__global__ void __launch_bounds__(kThreads)
mid_planes_kernel(const int* __restrict__ sa, const int* __restrict__ sb,
                  signed char* __restrict__ out, long long B, int M) {
  const int per_row = M / 4;
  const long long groups = B * per_row;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; g < groups;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = g / per_row;
    const long long at = row * 2LL * M + static_cast<int>(g - row * per_row) * 4;
    const int4 a0 = *reinterpret_cast<const int4*>(sa + at);
    const int4 a1 = *reinterpret_cast<const int4*>(sa + at + M);
    const int4 b0 = *reinterpret_cast<const int4*>(sb + at);
    const int4 b1 = *reinterpret_cast<const int4*>(sb + at + M);
    const int fa[4] = {fold<P>(a0.x, a1.x), fold<P>(a0.y, a1.y), fold<P>(a0.z, a1.z),
                       fold<P>(a0.w, a1.w)};
    const int fb[4] = {fold<P>(b0.x, b1.x), fold<P>(b0.y, b1.y), fold<P>(b0.z, b1.z),
                       fold<P>(b0.w, b1.w)};
    int prod[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)   // centered factors: |product| < 2^30
      prod[j] = (fa[j] > P / 2 ? fa[j] - P : fa[j]) * (fb[j] > P / 2 ? fb[j] - P : fb[j]);
    planes_of<P>(prod, out + at, out + at + M);
  }
}

// Residues r_j in [0, p_j) of one coefficient -> Garner's signed
// c = v1 + p1 v2 + p1 p2 v3 with v3 centered, so |c| < P/2 (2^43.8 for the
// tier-1 primes, 2^49.1 for the tier-2 ones).
template <class T>
__device__ __forceinline__ long long garner_coeff(int v1, int r2, int r3) {
  const int v2 = mf::mul_mod<T::P2>(mod_nonneg<T::P2>(r2 - v1), T::Inv12);
  const int t = mf::mul_mod<T::P3>(mod_nonneg<T::P3>(r3 - v1), T::Inv13);
  int v3 = mf::mul_mod<T::P3>(mod_nonneg<T::P3>(t - v2), T::Inv23);
  if (v3 > T::P3 / 2) v3 -= T::P3;
  return v1 + static_cast<long long>(T::P1) * v2 + static_cast<long long>(T::P1) * T::P2 * v3;
}

// The row's coefficients c (shared memory) -> out row: digit sums
// s_i = c_i mod 2^16 + (c_(i-1) >> 16 mod 2^16) + (c_(i-2) >> 32), pieces
// past the top wrapping negated (|s_i| < 2^18.2), then one carry pass.
__device__ __forceinline__ void spread_carry_row(const long long* c, int* s, int* outr, int M) {
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    int c1 = static_cast<int>((c[i == 0 ? M - 1 : i - 1] >> 16) & 0xFFFF);
    if (i < 1) c1 = -c1;
    int c2 = static_cast<int>(c[i >= 2 ? i - 2 : M - 2 + i] >> 32);
    if (i < 2) c2 = -c2;
    s[i] = static_cast<int>(c[i] & 0xFFFF) + c1 + c2;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < M; i += blockDim.x) outr[i] = mf::carry_digit(s, i, M);
}

// s1, s2, s3 (B, 2M) int32 raw inverse sums of the three tier-1 primes ->
// out (B, M) int32 bounded redundant digits: fold each to its residue,
// Garner, spread and carry.  One CTA per row.
__global__ void __launch_bounds__(kThreads)
garner_carry_kernel(const int* __restrict__ s1, const int* __restrict__ s2,
                    const int* __restrict__ s3, int* __restrict__ out, int M) {
  extern __shared__ long long c[];                   // M coefficients
  int* s = reinterpret_cast<int*>(c + M);            // M digit sums
  const long long row = blockIdx.x;
  const int* r1p = s1 + row * 2LL * M;
  const int* r2p = s2 + row * 2LL * M;
  const int* r3p = s3 + row * 2LL * M;
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    c[i] = garner_coeff<Tier1>(fold<kP1>(r1p[i], r1p[M + i]), fold<kP2>(r2p[i], r2p[M + i]),
                               fold<kP3>(r3p[i], r3p[M + i]));
  __syncthreads();
  spread_carry_row(c, s, out + row * M, M);
}

// r1, r2, r3 (B, M) int32 residues of the three tier-2 primes -> out
// (B, M) int32 bounded redundant digits.  One CTA per row.
__global__ void __launch_bounds__(kThreads)
garner_residues_kernel(const int* __restrict__ r1, const int* __restrict__ r2,
                       const int* __restrict__ r3, int* __restrict__ out, int M) {
  extern __shared__ long long c[];
  int* s = reinterpret_cast<int*>(c + M);
  const long long at = static_cast<long long>(blockIdx.x) * M;
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    c[i] = garner_coeff<Tier2>(r1[at + i], r2[at + i], r3[at + i]);
  __syncthreads();
  spread_carry_row(c, s, out + at, M);
}

// The garner_post form of both Garner kernels: K consecutive rows per CTA
// (Raw: the dense tier's (B, 2M) raw inverse sums, tier-1 primes; else the
// 4-step tier's (B, M) residues, tier-2 primes).  Every thread takes runs of
// up to 8 digits of any of the K rows: the coefficients at i0-3 .. i0+7
// (three aligned int4 windows per input row, wrapped mod M), their digit
// sums at i0-1 .. i0+7 and the carried digits i0 .. i0+7, straight into the
// K*M buffer; then the k inverse ladder stages in place over the K rows
// (h = 1, hpos = 0: K-index q is position q of the block) and one carry
// pass into out.
template <class T, bool Raw, int NT>
__global__ void __launch_bounds__(NT, NT == 256 ? 3 : 1)
garner_post_kernel(const int* __restrict__ s1, const int* __restrict__ s2,
                   const int* __restrict__ s3, int* __restrict__ out, int M, int K, int k,
                   mf::LadderSteps steps) {
  extern __shared__ int4 smem4[];
  int* buf = reinterpret_cast<int*>(smem4);
  int* tab0 = buf + K * M;
  int* tab1 = tab0 + k * (K / 2);
  const long long row0 = static_cast<long long>(blockIdx.x) * K;
  const long long stride = Raw ? 2LL * M : M;
  mf::ladder_table(tab0, tab1, K, k, M, 1, 0, true, steps, nullptr);
  const int rl = M < 8 ? M : 8;                      // digits per run
  const int rpr = M / rl;                            // runs per row (a power of two)
  const int lg = __ffs(rpr) - 1;
  for (int idx = threadIdx.x; idx < K * rpr; idx += NT) {
    const int q = idx >> lg;
    const int i0 = (idx - (q << lg)) * rl;
    const long long at = (row0 + q) * stride;
    long long c[12];                                 // c[t]: coefficient at i0 - 4 + t
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      int pos = i0 - 4 + 4 * ch;
      pos = pos < 0 ? pos + M : (pos >= M ? pos - M : pos);
      const int4 a1 = *reinterpret_cast<const int4*>(s1 + at + pos);
      const int4 a2 = *reinterpret_cast<const int4*>(s2 + at + pos);
      const int4 a3 = *reinterpret_cast<const int4*>(s3 + at + pos);
      const int v1[4] = {a1.x, a1.y, a1.z, a1.w};
      const int v2[4] = {a2.x, a2.y, a2.z, a2.w};
      const int v3[4] = {a3.x, a3.y, a3.z, a3.w};
      if constexpr (Raw) {
        const int4 h1 = *reinterpret_cast<const int4*>(s1 + at + M + pos);
        const int4 h2 = *reinterpret_cast<const int4*>(s2 + at + M + pos);
        const int4 h3 = *reinterpret_cast<const int4*>(s3 + at + M + pos);
        const int w1[4] = {h1.x, h1.y, h1.z, h1.w};
        const int w2[4] = {h2.x, h2.y, h2.z, h2.w};
        const int w3[4] = {h3.x, h3.y, h3.z, h3.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * ch + e > 0)
            c[4 * ch + e] = garner_coeff<T>(fold<T::P1>(v1[e], w1[e]), fold<T::P2>(v2[e], w2[e]),
                                            fold<T::P3>(v3[e], w3[e]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * ch + e > 0) c[4 * ch + e] = garner_coeff<T>(v1[e], v2[e], v3[e]);
      }
    }
    // digit sums (spread_carry_row) at i0 - 1 + u, u = 0..8; i0 - 1 is
    // M - 1 at i0 == 0, where no piece wraps
    int sum[9];
#pragma unroll
    for (int u = 0; u < 9; ++u) {
      const int j = i0 - 1 + u;
      int c1 = static_cast<int>((c[u + 2] >> 16) & 0xFFFF);
      if (j == 0) c1 = -c1;
      int c2 = static_cast<int>(c[u + 1] >> 32);
      if (j == 0 || j == 1) c2 = -c2;
      sum[u] = static_cast<int>(c[u + 3] & 0xFFFF) + c1 + c2;
    }
    int d[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int cy = sum[t] >> mf::DIGIT_BITS;
      d[t] = (sum[t + 1] & mf::DIGIT_MASK) + (i0 + t == 0 ? -cy : cy);
    }
    int* row = buf + q * M + i0;
    *reinterpret_cast<int4*>(row) = make_int4(d[0], d[1], d[2], d[3]);
    if (rl == 8) *reinterpret_cast<int4*>(row + 4) = make_int4(d[4], d[5], d[6], d[7]);
  }
  __syncthreads();
  mf::ladder_group<4, 4, NT>(buf, K, k, M, true, tab0, tab1, false, 0, k);
  mf::carry_store<4, NT>(buf, K, M, out, row0 * M, M);
}

bool bad_m(int M) { return M < 4 || M > kMaxM || (M & (M - 1)) != 0; }

template <class T, bool Raw, int NT>
int launch_post_nt(const void* s1, const void* s2, const void* s3, void* out, long long B, int M,
                   int K, int k, const mf::LadderSteps& st, size_t smem, void* stream) {
  const auto kernel = garner_post_kernel<T, Raw, NT>;
  const cudaError_t err = mf::prepare_group_kernel(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(B / K), NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(s1), static_cast<const int*>(s2), static_cast<const int*>(s3),
      static_cast<int*>(out), M, K, k, st);
  return static_cast<int>(cudaGetLastError());
}

// Launch the garner_post form over B rows (B a multiple of K = 2^k),
// inputs 16-byte aligned.  Which K and M launch is the wrapper's rule
// (ops/fused.py ladder_fits, through ops/ntt.py _check_post).
template <class T, bool Raw>
int launch_post(const void* s1, const void* s2, const void* s3, void* out, long long B, int M,
                int K, const void* steps_host, int k, void* stream) {
  if (k < 1 || k > mf::kMaxLadderStages || K != (1 << k) || B % K != 0 ||
      (reinterpret_cast<unsigned long long>(s1) | reinterpret_cast<unsigned long long>(s2) |
       reinterpret_cast<unsigned long long>(s3) | reinterpret_cast<unsigned long long>(out)) %
          16)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mf::ladder_smem_bytes(K, k, M);
  if (B / K > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  mf::LadderSteps st{};
  const long long* sh = static_cast<const long long*>(steps_host);
  for (int j = 0; j < k; ++j) st.s[j] = sh[j];
  const int nt = mf::group_threads(M / 4, 4, 512);
  if (nt == 256) return launch_post_nt<T, Raw, 256>(s1, s2, s3, out, B, M, K, k, st, smem, stream);
  if (nt == 512) return launch_post_nt<T, Raw, 512>(s1, s2, s3, out, B, M, K, k, st, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (B, M) int32, out (3, B, 2M) int8; rows 16-byte aligned.
MF_EXPORT int mf_input_planes(const void* x, void* out, long long B, int M, void* stream) {
  if (bad_m(M) || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  input_planes_kernel<<<mf::stream_blocks(B * (M / 4), kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<signed char*>(out), B, M);
  return static_cast<int>(cudaGetLastError());
}

// sa, sb (B, 2M) int32, out (B, 2M) int8; p: the prime itself, a tier-1
// prime or one of the pair tier's two others (18433, 59393: ntt_pair.cu's
// rows of M pairs).
MF_EXPORT int mf_mid_planes(const void* sa, const void* sb, void* out, long long B, int M, int p,
                            void* stream) {
  if (bad_m(M) || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const unsigned blocks = mf::stream_blocks(B * (M / 4), kThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(sa);
  const int* b = static_cast<const int*>(sb);
  signed char* o = static_cast<signed char*>(out);
  switch (p) {
    case kP1: mid_planes_kernel<kP1><<<blocks, kThreads, 0, st>>>(a, b, o, B, M); break;
    case kP2: mid_planes_kernel<kP2><<<blocks, kThreads, 0, st>>>(a, b, o, B, M); break;
    case kP3: mid_planes_kernel<kP3><<<blocks, kThreads, 0, st>>>(a, b, o, B, M); break;
    case kPairP2: mid_planes_kernel<kPairP2><<<blocks, kThreads, 0, st>>>(a, b, o, B, M); break;
    case kPairP4: mid_planes_kernel<kPairP4><<<blocks, kThreads, 0, st>>>(a, b, o, B, M); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// s1, s2, s3 (B, 2M) int32 (primes 12289, 40961, 61441 in that order),
// out (B, M) int32.  post_K: 0, or K = 2^k for the garner_post leg with the
// k stage exponents steps (host long long[k]).
MF_EXPORT int mf_garner_carry(const void* s1, const void* s2, const void* s3, void* out,
                              long long B, int M, int post_K, const void* steps, int k,
                              void* stream) {
  if (bad_m(M) || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (post_K) return launch_post<Tier1, true>(s1, s2, s3, out, B, M, post_K, steps, k, stream);
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(M) * (sizeof(long long) + sizeof(int));
  garner_carry_kernel<<<static_cast<unsigned>(B), mf::row_threads(M, kThreads), smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(s1), static_cast<const int*>(s2), static_cast<const int*>(s3),
      static_cast<int*>(out), M);
  return static_cast<int>(cudaGetLastError());
}

// r1, r2, r3 (B, M) int32 residues in [0, p) of the primes 65537, 114689,
// 163841 in that order, out (B, M) int32; M = 4096 or 8192 (2048: the
// --ab4 A/B of utils/prof_pointwise.py, ntt4.cu).  post_K, steps, k: as
// mf_garner_carry's.
MF_EXPORT int mf_garner_residues(const void* r1, const void* r2, const void* r3, void* out,
                                 long long B, int M, int post_K, const void* steps, int k,
                                 void* stream) {
  if ((M != 2048 && M != 4096 && M != 8192) || B < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (post_K) return launch_post<Tier2, false>(r1, r2, r3, out, B, M, post_K, steps, k, stream);
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(M) * (sizeof(long long) + sizeof(int));
  const cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(garner_residues_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  garner_residues_kernel<<<static_cast<unsigned>(B), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(r1), static_cast<const int*>(r2), static_cast<const int*>(r3),
      static_cast<int*>(out), M);
  return static_cast<int>(cudaGetLastError());
}
