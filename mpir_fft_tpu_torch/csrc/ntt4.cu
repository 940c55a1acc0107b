// The 4-step (tier-2) NTT-CRT pointwise product mod 2^(16M)+1, M = 4096 or
// 8192 (ops/ntt.py _mulmod_4step): the link kernels between its int8
// GEMMs, and the fused kernel that runs the whole pipeline per row.
//
// Replaces: mpir_fft_tpu/ops/ntt.py
//   ntt4_input_planes   <- _link3_multi (ntt.py:821, pallas_call :851) with the
//                          body of _ntt4_input_planes (ntt.py:862)
//   ntt4_fwd_twiddle    <- _link3 (ntt.py:783, pallas_call :811) with k_mid1
//   ntt4_pointwise      <- _link3 with k_pw
//   ntt4_inv_twiddle    <- _link3 with k_mid3
//   ntt4_residues       <- _link3 with k_out (the bodies: _ntt4_linked_parts,
//                          ntt.py:894-938)
//   ntt4_fused          <- _fused_mulmod_fn's kernel_ntt (ntt.py:1115,
//                          pallas_call :1177); its kernel_crt (:1186) is
//                          garner_residues in ntt_links.cu
// Plain versions: ops/ntt.py ntt4_*_plain -- the same integer sequences, so
// the outputs are identical (and equal to the reference's: every output is
// a function of exact residues).
//
// M = m1 m2 (m1 = 64; m2 = 64 or 128), digit i = i1 m2 + i2, three primes
// 65537, 114689, 163841 and three signed-int8 planes per value (v = p0 +
// 256 p1 + 65536 p2 of the centered residue).  The layouts are the port's
// own: each link writes its planes as the rows the next torch._int_mm
// contracts, contraction last (ops/ntt.py lists them); the transposes of
// the 4-step (i2 <-> k1 after F1, k1 <-> i2 before G1, (i2, i1) -> digit
// order at the end) happen inside the links, on one row held in shared
// memory.  Raw plane sums are below 3m 128^2 < 2^22.6; the fold
// S2 mod p -> (S1 + 256 acc) mod p -> (S0 + 256 acc) mod p stays int32
// (each step < 2^25.5); a product of two residues takes 64 bits.  Each
// kernel is templated on its prime.
//
// What bounds the links on an H100: device memory.  Per value they read 4
// bytes of digits (input planes; 9 bytes of planes out) or 12 bytes of
// sums (24 for the pointwise) and write 3 bytes of planes or 4 of residue.
// Design: the transposing links take one CTA per row and keep the row's
// folded values in shared memory at a stride of R+1 (R a power of two), so
// that the transposed store and the row-order read are both free of bank
// conflicts; reads are coalesced int32, writes coalesced bytes.  The
// pointwise link is elementwise (a grid-stride loop).
//
// ntt4_fused is bound by its 18 block products per row (2.4 x 10^6 int8
// multiply-adds per prime and GEMM at M = 4096), done here with __dp4a on
// the CUDA cores: a simple first version.  One CTA per row holds two plane
// buffers and both spectra in shared memory (14 M bytes); the [3m, 3m]
// blocks (36 KB or 144 KB, column-major) are read from global memory
// through L1/L2, each column word shared by a tile of 8 rows per thread.
#include "ntt_common.cuh"

namespace {

using mf::mod_center;
using mf::mod_nonneg;
using mf::mul_mod;

constexpr int kQ1 = 65537, kQ2 = 114689, kQ3 = 163841;
constexpr int kThreads = 256;
constexpr int kRowTile = 8;   // rows per thread in the fused kernel's block products

// Raw plane sums (S0, S1, S2) -> sum_j 256^j S_j mod P in [0, P)
template <int P>
__device__ __forceinline__ int fold3(int s0, int s1, int s2) {
  int acc = mod_nonneg<P>(s2);
  acc = mod_nonneg<P>(s1 + mf::shl(acc, 8));
  return mod_nonneg<P>(s0 + mf::shl(acc, 8));
}

// The three planes of a centered residue rc at dst[0], dst[stride],
// dst[2 stride]: rc = p0 + 256 p1 + 65536 p2, p0 and p1 in [-128, 128).
__device__ __forceinline__ void put_planes(signed char* dst, int stride, int rc) {
  const int p0 = ((rc + 128) & 255) - 128;
  rc = (rc - p0) >> 8;
  const int p1 = ((rc + 128) & 255) - 128;
  dst[0] = static_cast<signed char>(p0);
  dst[stride] = static_cast<signed char>(p1);
  dst[2 * stride] = static_cast<signed char>((rc - p1) >> 8);
}

// x (B, M) int32 -> out (3, B*m2, 3*m1) int8: the balanced carry pass of
// each row, then per prime the planes of the centered residues, row
// (b, i2), column j*m1 + i1.  One CTA per row.
__global__ void __launch_bounds__(kThreads)
ntt4_input_planes_kernel(const int* __restrict__ x, signed char* __restrict__ out, long long B,
                         int lg1, int lg2) {
  extern __shared__ int xs[];                        // [i1][i2], stride m2 + 1
  const int m1 = 1 << lg1, m2 = 1 << lg2, M = m1 * m2;
  const long long b = blockIdx.x;
  const int* xr = x + b * M;
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    xs[(i >> lg2) * (m2 + 1) + (i & (m2 - 1))] = mf::balanced_digit(xr, i, M);
  __syncthreads();
  const long long slab = B * 3LL * M;
  for (int o = threadIdx.x; o < M; o += blockDim.x) {
    const int i2 = o >> lg1, i1 = o & (m1 - 1);
    const int v = xs[i1 * (m2 + 1) + i2];
    signed char* dst = out + (b * m2 + i2) * 3LL * m1 + i1;
    put_planes(dst, m1, mod_center<kQ1>(v));
    put_planes(dst + slab, m1, mod_center<kQ2>(v));
    put_planes(dst + 2 * slab, m1, mod_center<kQ3>(v));
  }
}

// One row b of raw sums S (B*R, 3C): row (b, r), column j*C + c -> the
// folded value v[r][c] (times tab[r][c] mod P where kTwiddle), transposed:
//   kTwiddle: planes of centered v to out (B*C, 3R) int8, row (b, c),
//             column j*R + r;
//   else:     v itself to out (B, C*R) int32 at c*R + r.
template <int P, bool kTwiddle>
__device__ __forceinline__ void fold_transpose_row(const int* __restrict__ S,
                                                   const int* __restrict__ tab, void* out,
                                                   int lgR, int lgC) {
  extern __shared__ int vs[];                        // [c][r], stride R + 1
  const int R = 1 << lgR, C = 1 << lgC, N = R * C;
  const long long b = blockIdx.x;
  const int* Sr = S + b * 3LL * N;
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    const int r = e >> lgC, c = e & (C - 1);
    const int* s = Sr + r * 3 * C + c;
    int v = fold3<P>(s[0], s[C], s[2 * C]);
    if (kTwiddle) v = mul_mod<P>(v, tab[e]);
    vs[c * (R + 1) + r] = v;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < N; e += blockDim.x) {
    const int c = e >> lgR, r = e & (R - 1);
    const int v = vs[c * (R + 1) + r];
    if (kTwiddle) {
      put_planes(static_cast<signed char*>(out) + (b * C + c) * 3LL * R + r, R, mod_center<P>(v));
    } else {
      static_cast<int*>(out)[b * N + e] = v;
    }
  }
}

// k_mid1: F1 sums (B*m2, 3*m1) -> planes (B*m1, 3*m2) of v times T (R = m2, C = m1)
template <int P>
__global__ void __launch_bounds__(kThreads)
ntt4_fwd_twiddle_kernel(const int* __restrict__ S, const int* __restrict__ T,
                        signed char* __restrict__ out, int lgR, int lgC) {
  fold_transpose_row<P, true>(S, T, out, lgR, lgC);
}

// k_mid3: G2 sums (B*m1, 3*m2) -> planes (B*m2, 3*m1) of v times Ti (R = m1, C = m2)
template <int P>
__global__ void __launch_bounds__(kThreads)
ntt4_inv_twiddle_kernel(const int* __restrict__ S, const int* __restrict__ Ti,
                        signed char* __restrict__ out, int lgR, int lgC) {
  fold_transpose_row<P, true>(S, Ti, out, lgR, lgC);
}

// k_out: G1 sums (B*m2, 3*m1) -> residues (B, M) in digit order (R = m2, C = m1)
template <int P>
__global__ void __launch_bounds__(kThreads)
ntt4_residues_kernel(const int* __restrict__ S, int* __restrict__ out, int lgR, int lgC) {
  fold_transpose_row<P, false>(S, nullptr, out, lgR, lgC);
}

// k_pw: sa, sb (rows, 3C) int32 F2 sums -> out (rows, 3C) int8, the planes
// of the folded values' product mod P.  Elementwise over (row, c).
template <int P>
__global__ void __launch_bounds__(kThreads)
ntt4_pointwise_kernel(const int* __restrict__ sa, const int* __restrict__ sb,
                      signed char* __restrict__ out, long long rows, int lgC) {
  const int C = 1 << lgC;
  const long long n = rows << lgC;
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; g < n;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long at = (g >> lgC) * 3 * C + (g & (C - 1));
    const int fa = fold3<P>(sa[at], sa[at + C], sa[at + 2 * C]);
    const int fb = fold3<P>(sb[at], sb[at + C], sb[at + 2 * C]);
    put_planes(out + at, C, mod_center<P>(mul_mod<P>(fa, fb)));
  }
}

// ---- the fused kernel ------------------------------------------------------

// One block product of the fused pipeline: planes X (shared memory, rows of
// K = 3m int8) against the [K, K] block F (global memory, column-major:
// column c at c*K).  For each (r, k < m): S_j = sum_q X[r][q] F[q][j m + k],
// then emit(r, k, fold3(S0, S1, S2)).  Four int8 products per __dp4a; a
// thread takes kRowTile rows of one column k, so each F word it loads
// serves kRowTile rows (the X words are broadcasts within a warp).
template <int P, class Emit>
__device__ __forceinline__ void block_product(const signed char* X, const signed char* F,
                                              int rows, int lgm, Emit emit) {
  const int m = 1 << lgm, Kw = 3 * m / 4;
  const int* Xw = reinterpret_cast<const int*>(X);
  const int* Fw = reinterpret_cast<const int*>(F);
  const int tasks = (rows / kRowTile) << lgm;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int k = t & (m - 1), r0 = (t >> lgm) * kRowTile;
    const int* f0 = Fw + k * Kw;
    const int* f1 = Fw + (m + k) * Kw;
    const int* f2 = Fw + (2 * m + k) * Kw;
    int s[kRowTile][3];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) s[r][0] = s[r][1] = s[r][2] = 0;
    for (int q = 0; q < Kw; ++q) {
      const int a0 = __ldg(f0 + q), a1 = __ldg(f1 + q), a2 = __ldg(f2 + q);
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        const int xw = Xw[(r0 + r) * Kw + q];
        s[r][0] = __dp4a(xw, a0, s[r][0]);
        s[r][1] = __dp4a(xw, a1, s[r][1]);
        s[r][2] = __dp4a(xw, a2, s[r][2]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) emit(r0 + r, k, fold3<P>(s[r][0], s[r][1], s[r][2]));
  }
}

// Shared-memory buffers of one row: two plane buffers of 3M bytes and the
// two operands' spectra (M int32 each).
struct FusedSmem {
  signed char* plA;
  signed char* plB;
  int* fa;
  int* fb;
};

// One prime of the fused pipeline on row a (and b; square: b == a) ->
// residues in [0, P) to out (digit order).  tab: this prime's F1, F2, G1,
// G2 (column-major int8), T, Ti (int32), packed (ops/ntt.py
// _ntt4_fused_tables).
template <int P>
__device__ void fused_prime(const int* __restrict__ a, const int* __restrict__ b, bool square,
                            const unsigned char* __restrict__ tab, int* __restrict__ out,
                            int lg1, int lg2, const FusedSmem& sm) {
  const int m1 = 1 << lg1, m2 = 1 << lg2, M = m1 * m2, K1 = 3 * m1, K2 = 3 * m2;
  const signed char* F1 = reinterpret_cast<const signed char*>(tab);
  const signed char* F2 = F1 + K1 * K1;
  const signed char* G1 = F2 + K2 * K2;
  const signed char* G2 = G1 + K1 * K1;
  const int* T = reinterpret_cast<const int*>(G2 + K2 * K2);
  const int* Ti = T + M;

  auto forward = [&](const int* x, int* spec) {
    // input planes [i2][(j, i1)]
    for (int i = threadIdx.x; i < M; i += blockDim.x)
      put_planes(sm.plA + (i & (m2 - 1)) * K1 + (i >> lg2), m1,
                 mod_center<P>(mf::balanced_digit(x, i, M)));
    __syncthreads();
    // F1, times T, transposed: planes [k1][(j, i2)]
    block_product<P>(sm.plA, F1, m2, lg1, [&](int i2, int k1, int v) {
      put_planes(sm.plB + k1 * K2 + i2, m2, mod_center<P>(mul_mod<P>(v, T[i2 * m1 + k1])));
    });
    __syncthreads();
    // F2: the spectrum [k1][k2]
    block_product<P>(sm.plB, F2, m1, lg2, [&](int k1, int k2, int v) { spec[k1 * m2 + k2] = v; });
    __syncthreads();
  };
  forward(a, sm.fa);
  if (!square) forward(b, sm.fb);
  const int* fb = square ? sm.fa : sm.fb;
  // the pointwise product's planes [k1][(j, k2)]
  for (int e = threadIdx.x; e < M; e += blockDim.x)
    put_planes(sm.plA + (e >> lg2) * K2 + (e & (m2 - 1)), m2,
               mod_center<P>(mul_mod<P>(sm.fa[e], fb[e])));
  __syncthreads();
  // G2, times Ti, transposed: planes [i2][(j, k1)]
  block_product<P>(sm.plA, G2, m1, lg2, [&](int k1, int i2, int v) {
    put_planes(sm.plB + i2 * K1 + k1, m1, mod_center<P>(mul_mod<P>(v, Ti[k1 * m2 + i2])));
  });
  __syncthreads();
  // G1: residues [i2][i1] -> digit i1*m2 + i2
  block_product<P>(sm.plB, G1, m2, lg1, [&](int i2, int i1, int v) { out[(i1 << lg2) + i2] = v; });
  __syncthreads();
}

// a, b (B, M) int32 digits -> out (3, B, M) int32 residues of the three
// primes.  One CTA per row; 14 M bytes of dynamic shared memory.
__global__ void __launch_bounds__(kThreads)
ntt4_fused_kernel(const int* __restrict__ a, const int* __restrict__ b,
                  const unsigned char* __restrict__ tables, int* __restrict__ out, long long B,
                  int lg1, int lg2) {
  extern __shared__ int4 smem4[];
  const int m1 = 1 << lg1, m2 = 1 << lg2, M = m1 * m2;
  signed char* base = reinterpret_cast<signed char*>(smem4);
  const FusedSmem sm{base, base + 3 * M, reinterpret_cast<int*>(base + 6 * M),
                     reinterpret_cast<int*>(base + 6 * M) + M};
  const long long at = static_cast<long long>(blockIdx.x) * M;
  const bool square = a == b;
  const long long per_prime = 2LL * (9 * m1 * m1 + 9 * m2 * m2) + 8LL * M;
  fused_prime<kQ1>(a + at, b + at, square, tables, out + at, lg1, lg2, sm);
  fused_prime<kQ2>(a + at, b + at, square, tables + per_prime, out + B * M + at, lg1, lg2, sm);
  fused_prime<kQ3>(a + at, b + at, square, tables + 2 * per_prime, out + 2 * B * M + at, lg1,
                   lg2, sm);
}

int lg_of(int v) { return 31 - __builtin_clz(static_cast<unsigned>(v)); }

bool bad_m(int M) { return M != 4096 && M != 8192; }

// the 4-step split M = m1 m2 of ops/ntt.py _ntt4_shape
void split(int M, int* lg1, int* lg2) {
  const int lg = lg_of(M);
  *lg1 = lg / 2;
  *lg2 = lg - lg / 2;
}

bool bad_side(int v) { return v != 64 && v != 128; }

}  // namespace

// x (B, M) int32, out (3, B*m2, 3*m1) int8; rows 16-byte aligned.
MF_EXPORT int mf_ntt4_input_planes(const void* x, void* out, long long B, int M, void* stream) {
  if (bad_m(M) || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int lg1, lg2;
  split(M, &lg1, &lg2);
  const size_t smem = static_cast<size_t>(1 << lg1) * ((1 << lg2) + 1) * sizeof(int);
  ntt4_input_planes_kernel<<<static_cast<unsigned>(B), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<signed char*>(out), B, lg1, lg2);
  return static_cast<int>(cudaGetLastError());
}

// S (B*R, 3C) int32, table (R, C) int32 (T or Ti), out (B*C, 3R) int8;
// prime: index 0..2 into 65537, 114689, 163841; inverse: the k_mid3 kernel
// (else k_mid1).
MF_EXPORT int mf_ntt4_twiddle(const void* S, const void* table, void* out, long long B, int R,
                              int C, int prime, int inverse, void* stream) {
  if (bad_side(R) || bad_side(C) || B < 0 || prime < 0 || prime > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(C) * (R + 1) * sizeof(int);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(B);
  const int* s = static_cast<const int*>(S);
  const int* t = static_cast<const int*>(table);
  signed char* o = static_cast<signed char*>(out);
  const int lgR = lg_of(R), lgC = lg_of(C);
  if (!inverse) {
    if (prime == 0) ntt4_fwd_twiddle_kernel<kQ1><<<grid, kThreads, smem, st>>>(s, t, o, lgR, lgC);
    else if (prime == 1) ntt4_fwd_twiddle_kernel<kQ2><<<grid, kThreads, smem, st>>>(s, t, o, lgR, lgC);
    else ntt4_fwd_twiddle_kernel<kQ3><<<grid, kThreads, smem, st>>>(s, t, o, lgR, lgC);
  } else {
    if (prime == 0) ntt4_inv_twiddle_kernel<kQ1><<<grid, kThreads, smem, st>>>(s, t, o, lgR, lgC);
    else if (prime == 1) ntt4_inv_twiddle_kernel<kQ2><<<grid, kThreads, smem, st>>>(s, t, o, lgR, lgC);
    else ntt4_inv_twiddle_kernel<kQ3><<<grid, kThreads, smem, st>>>(s, t, o, lgR, lgC);
  }
  return static_cast<int>(cudaGetLastError());
}

// sa, sb, out (rows, 3C): int32 sums in, int8 planes out.
MF_EXPORT int mf_ntt4_pointwise(const void* sa, const void* sb, void* out, long long rows, int C,
                                int prime, void* stream) {
  if (bad_side(C) || rows < 0 || prime < 0 || prime > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const unsigned blocks = mf::stream_blocks(rows * C, kThreads);
  const auto st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(sa);
  const int* b = static_cast<const int*>(sb);
  signed char* o = static_cast<signed char*>(out);
  const int lgC = lg_of(C);
  if (prime == 0) ntt4_pointwise_kernel<kQ1><<<blocks, kThreads, 0, st>>>(a, b, o, rows, lgC);
  else if (prime == 1) ntt4_pointwise_kernel<kQ2><<<blocks, kThreads, 0, st>>>(a, b, o, rows, lgC);
  else ntt4_pointwise_kernel<kQ3><<<blocks, kThreads, 0, st>>>(a, b, o, rows, lgC);
  return static_cast<int>(cudaGetLastError());
}

// S (B*m2, 3*m1) int32 G1 sums, out (B, M) int32 residues.
MF_EXPORT int mf_ntt4_residues(const void* S, void* out, long long B, int M, int prime,
                               void* stream) {
  if (bad_m(M) || B < 0 || prime < 0 || prime > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int lg1, lg2;
  split(M, &lg1, &lg2);
  // R = m2 (i2), C = m1 (i1)
  const size_t smem = static_cast<size_t>(1 << lg1) * ((1 << lg2) + 1) * sizeof(int);
  const auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(B);
  const int* s = static_cast<const int*>(S);
  int* o = static_cast<int*>(out);
  if (prime == 0) ntt4_residues_kernel<kQ1><<<grid, kThreads, smem, st>>>(s, o, lg2, lg1);
  else if (prime == 1) ntt4_residues_kernel<kQ2><<<grid, kThreads, smem, st>>>(s, o, lg2, lg1);
  else ntt4_residues_kernel<kQ3><<<grid, kThreads, smem, st>>>(s, o, lg2, lg1);
  return static_cast<int>(cudaGetLastError());
}

// a, b (B, M) int32 (b == a: a square), tables (ops/ntt.py
// _ntt4_fused_tables), out (3, B, M) int32.
MF_EXPORT int mf_ntt4_fused(const void* a, const void* b, const void* tables, void* out,
                            long long B, int M, void* stream) {
  if (bad_m(M) || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int lg1, lg2;
  split(M, &lg1, &lg2);
  const size_t smem = 14 * static_cast<size_t>(M);
  const cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(ntt4_fused_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt4_fused_kernel<<<static_cast<unsigned>(B), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<const unsigned char*>(tables), static_cast<int*>(out), B, lg1, lg2);
  return static_cast<int>(cudaGetLastError());
}
