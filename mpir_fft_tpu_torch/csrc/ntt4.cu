// The 4-step (tier-2) NTT-CRT pointwise product mod 2^(16M)+1, M = 4096 or
// 8192 (ops/ntt.py _mulmod_4step): the link kernels between its int8
// GEMMs.  The fused kernel that runs the whole pipeline per row is
// csrc/ntt4_fused.cu (built apart, so that the two compile in parallel).
//
// Replaces: mpir_fft_tpu/ops/ntt.py
//   ntt4_input_planes   <- _link3_multi (ntt.py:821, pallas_call :851) with the
//                          body of _ntt4_input_planes (ntt.py:862)
//   ntt4_fwd_twiddle    <- _link3 (ntt.py:783, pallas_call :811) with k_mid1
//   ntt4_pointwise      <- _link3 with k_pw
//   ntt4_inv_twiddle    <- _link3 with k_mid3
//   ntt4_residues       <- _link3 with k_out (the bodies: _ntt4_linked_parts,
//                          ntt.py:894-938)
// Plain versions: ops/ntt.py ntt4_*_plain -- the same integer sequences, so
// the outputs are identical (and equal to the reference's: every output is
// a function of exact residues).
//
// M = m1 m2 (m1 = 64; m2 = 64 or 128; at M 2048, prof_pointwise's A/B
// only, m1 32 and m2 64), digit i = i1 m2 + i2, three primes
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
#include <cstdint>

#include "ntt_common.cuh"

namespace {

using mf::mod_center;
using mf::mod_nonneg;
using mf::mul_mod;

constexpr int kQ1 = 65537, kQ2 = 114689, kQ3 = 163841;
constexpr int kThreads = 256;

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


int lg_of(int v) { return 31 - __builtin_clz(static_cast<unsigned>(v)); }

// M 2048 (m1 32, m2 64) too: the dense tier's widest ring through the
// 4-step tier, which utils/prof_pointwise.py --ab4 times beside the dense
// tier (the reference's tools/prof_pointwise.py A/B); no plan routes it here
bool bad_m(int M) { return M != 2048 && M != 4096 && M != 8192; }

// the 4-step split M = m1 m2 of ops/ntt.py _ntt4_shape
void split(int M, int* lg1, int* lg2) {
  const int lg = lg_of(M);
  *lg1 = lg / 2;
  *lg2 = lg - lg / 2;
}

bool bad_side(int v) { return v != 32 && v != 64 && v != 128; }

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
