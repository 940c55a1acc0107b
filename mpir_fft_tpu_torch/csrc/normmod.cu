// Exact canonicalization of ring elements, with a static power-of-two shift:
// out = normmod(x * 2^s mod 2^(16L)+1) for every row.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_rows (fused.py:503) as used by
// limb.normmod_div (limb.py:214-230): the inverse transform's divide by
// 2^lg_conv + normalize tail (s = 2W - lg_conv); s = 0 is plain normmod.
// Plain version: ops/fused.py normmod_rows_plain.  The output is canonical,
// so it equals the JAX result bit for bit.  The row body (shift, two carry
// passes, exact carry scan, carry-out fold) is mf::normmod_row in
// normmod_row.cuh, shared with the inverse sqrt2 top merge.
//
// What bounds it on an H100: device memory -- one read and one write of the
// row (8 bytes per digit) against ~30 shared-memory steps per digit.
// Design: one CTA per row, the row in shared memory through every phase
// (rows of L <= kRowMaxL digits: every ring of the flagship and of the
// recursive mulmod's inner levels).  A longer row -- the single ring of a
// mulmod_int product at N = 2^22..2^24 bits, L = 2^18..2^20 -- cannot sit in
// a block's shared memory, so normmod_long_kernel streams it: one CTA per
// row, the shift and the two carry passes through global scratch, then the
// exact-carry scan tile by tile (a block scan per tile, the composed
// transition of the tiles before it carried across), then the carry-out
// fold.  It is a single SM's work per row: ~4 passes over the row at one
// SM's bandwidth, fine for the one or two such rows a mulmod_int has.
#include "normmod_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowMaxL = 8192;     // 3 L ints of shared memory = 96 KB
constexpr int kLongThreads = 1024;
constexpr int kIdentity = 0 | (1 << 2) | (2 << 4);   // f(c) = c

__global__ void __launch_bounds__(kThreads)
normmod_kernel(const int* __restrict__ x, int* __restrict__ out, int L, int kd, int b,
               int neg) {
  extern __shared__ int sm[];
  __shared__ int first;
  const long long row = blockIdx.x;
  const int* xr = x + row * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) sm[i] = xr[i];
  __syncthreads();
  mf::normmod_row(sm, sm + L, sm + 2 * L, &first, L, kd, b, neg, out + row * L);
}

__global__ void __launch_bounds__(kLongThreads)
normmod_long_kernel(const int* __restrict__ x, int* __restrict__ out, int* __restrict__ s1,
                    int* __restrict__ s2, int L, int kd, int b, int neg) {
  __shared__ int scan[2][kLongThreads];
  __shared__ int first;
  const long long row = blockIdx.x;
  const int* xr = x + row * L;
  int* o = out + row * L;
  int* A = s1 + row * L;
  int* B = s2 + row * L;
  const int t = threadIdx.x;

  // static shift, then two carry passes: digits in [-1, 2^16]
  for (int i = t; i < L; i += kLongThreads) {
    int v = mf::rot_digit(xr, i, kd, L);
    if (b) v = mf::shift_bits_digit(v, mf::rot_digit(xr, i == 0 ? L - 1 : i - 1, kd, L), i, b);
    A[i] = neg ? -v : v;
  }
  __syncthreads();
  for (int i = t; i < L; i += kLongThreads) B[i] = mf::carry_digit(A, i, L);
  __syncthreads();
  for (int i = t; i < L; i += kLongThreads) A[i] = mf::carry_digit(B, i, L);
  __syncthreads();

  // exact carries, tile by tile: run = the composed transition of all
  // digits before the tile
  int run = kIdentity;
  for (int base = 0; base < L; base += kLongThreads) {
    const int i = base + t;
    const int d = i < L ? A[i] : 0;
    int* src = scan[0];
    int* dst = scan[1];
    src[t] = i < L ? mf::tr_make(d) : kIdentity;
    __syncthreads();
    for (int off = 1; off < kLongThreads; off <<= 1) {
      dst[t] = t >= off ? mf::tr_compose(src[t], src[t - off]) : src[t];
      __syncthreads();
      int* tmp = src;
      src = dst;
      dst = tmp;
    }
    const int before = mf::tr_compose(t > 0 ? src[t - 1] : kIdentity, run);
    if (i < L) o[i] = (d + mf::tr_apply(before, 0)) & mf::DIGIT_MASK;
    run = mf::tr_compose(src[kLongThreads - 1], run);
    __syncthreads();
  }
  mf::fold_carry_out(o, o, mf::tr_apply(run, 0), &first, L);
}

}  // namespace

// Rows longer than this take the streaming kernel, which needs `scratch`.
MF_EXPORT int mf_normmod_row_max() { return kRowMaxL; }

// scratch: 2 * B * L ints when L > mf_normmod_row_max(), else unused.
MF_EXPORT int mf_normmod(const void* x, void* out, void* scratch, long long B, int L, int s,
                         void* stream) {
  const long long W = 16LL * L;
  if (L < 1 || s < 0 || s >= 2 * W) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int neg = s >= W;
  const int r = static_cast<int>(neg ? s - W : s);
  if (L > kRowMaxL) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    int* s1 = static_cast<int*>(scratch);
    normmod_long_kernel<<<static_cast<unsigned>(B), kLongThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(out), s1, s1 + B * L, L, r >> 4, r & 15,
        neg);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 3ull * L * sizeof(int);
  cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(normmod_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  normmod_kernel<<<static_cast<unsigned>(B), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), L, r >> 4, r & 15, neg);
  return static_cast<int>(cudaGetLastError());
}
