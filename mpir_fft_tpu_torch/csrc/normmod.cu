// Exact canonicalization of ring elements, with a static power-of-two shift:
// out = normmod(x * 2^s mod 2^(16L)+1) for every row.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_rows (fused.py:503, pallas_call
// :521) as used by limb.normmod / limb.normmod_div (limb.py:194-230): the
// inverse transform's divide by 2^lg_conv + normalize tail (s = 2W -
// lg_conv); s = 0 is plain normmod.  Plain version: ops/fused.py
// normmod_rows_plain.  The output is canonical, so it equals the JAX result
// bit for bit.
//
// What bounds it on an H100: device memory -- one read and one write of the
// row, 8 bytes a digit.  Three routes by row length (ops/fused.py
// normmod_route, the limits exported below):
//   * short rows, L <= kShortMaxL (the recursive pointwise's inner rings, L
//     32-72, and the outer rings up to 512): normmod_short_kernel, G <= 32
//     lanes a row and several rows a warp, each lane D = V*R digits in
//     registers (mf::normmod_short in normmod_row.cuh: shuffles only, no
//     shared memory, no barrier);
//   * block rows, up to kRowMaxL (the outer rings L 1024-8192):
//     normmod_block_kernel, one CTA a row, 8 digits a thread in as many
//     whole warps as the row needs, O(L) work and two or three barriers
//     (mf::normmod_row; its exact carry is also the inverse sqrt2 top merge's
//     norm tail);
//   * longer rows -- the single ring of a mulmod_int product at N = 2^22..
//     2^25 bits, L = 2^18..2^21 -- stream: normmod_long_kernel, one CTA per
//     row, the shift and the two carry passes through global scratch, then
//     the exact-carry scan tile by tile (a block scan per tile, the composed
//     transition of the tiles before it carried across), then the carry-out
//     fold.  It is a single SM's work per row: ~4 passes over the row at one
//     SM's bandwidth, fine for the one or two such rows a mulmod_int has.
// The kernels choose their layout from L and the rows' alignment
// (mf::run_width, short_runs, mf::block_row_threads).
#include "normmod_row.cuh"

// The long-row kernel's helpers: transitions packed 2 bits per input value
// (bits 2(c+1)..2(c+1)+1 hold f(c) + 1 for c in {-1, 0, 1}), and the
// carry-out fold over a row in device memory.
namespace mf {

__device__ __forceinline__ int tr_apply(int code, int c) {
  return ((code >> (2 * (c + 1))) & 3) - 1;
}

__device__ __forceinline__ int tr_make(int d) {
  return (((d - 1) >> 16) + 1) | (((d >> 16) + 1) << 2) | ((((d + 1) >> 16) + 1) << 4);
}

// later o earlier: the transition of two consecutive digit ranges
__device__ __forceinline__ int tr_compose(int later, int earlier) {
  int r = 0;
  for (int c = -1; c <= 1; ++c) r |= (tr_apply(later, tr_apply(earlier, c)) + 1) << (2 * (c + 1));
  return r;
}

// out = r - cout (mod p) for canonical digits r (no -1 form) and a carry-out
// cout in {-1, 0, 1}: a +1 ripples through the leading 0xffff digits (cout
// == -1), a -1 through the leading zero digits (cout == +1); when every digit
// propagates the result is the -1 form.  out may alias r (each thread
// rewrites only digits it read); first: a shared int.  Every thread of the
// block calls it; it ends in __syncthreads.
__device__ inline void fold_carry_out(const int* r, int* out, int cout, int* first, int L) {
  if (threadIdx.x == 0) *first = L;
  __syncthreads();
  if (cout != 0) {
    const int prop = cout == -1 ? DIGIT_MASK : 0;
    for (int i = threadIdx.x; i < L; i += blockDim.x)
      if (r[i] != prop) atomicMin(first, i);
  }
  __syncthreads();
  const int f = *first;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int v = r[i];
    int o;
    if (cout == 0) o = v;
    else if (f == L) o = i == 0 ? -1 : 0;
    else if (cout == -1) o = i < f ? 0 : (i == f ? v + 1 : v);
    else o = i < f ? DIGIT_MASK : (i == f ? v - 1 : v);
    out[i] = o;
  }
  __syncthreads();
}

}  // namespace mf

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kShortMaxL = 512;
constexpr int kRowMaxL = 8192;
constexpr int kLongThreads = 1024;
constexpr int kBlockMaxThreads = 1024;

constexpr int kIdentity = 0 | (1 << 2) | (2 << 4);   // f(c) = c (the long kernel's code)

// rpw rows of G lanes in each warp of kThreads; row = (block * kWarps +
// warp) * rpw + lane / G.
template <int V, int R>
__global__ void __launch_bounds__(kThreads)
normmod_short_kernel(const int* __restrict__ x, int* __restrict__ out, long long B, int L, int s,
                     int G, int rpw) {
  const int lane = threadIdx.x & 31;
  const int slot = lane / G;
  const int g = lane - slot * G;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * rpw + slot;
  const bool live = slot < rpw && row < B;
  const long long off = live ? row * L : 0;
  mf::normmod_short<V, R>(x + off, out + off, L, s, G, slot * G, g, live);
}

// one CTA a row, blockDim.x = mf::block_row_threads(L)
template <int V>
__global__ void __launch_bounds__(kBlockMaxThreads)
normmod_block_kernel(const int* __restrict__ x, int* __restrict__ out, int L, int s) {
  const long long off = static_cast<long long>(blockIdx.x) * L;
  mf::normmod_row<V, mf::kBlockDigits / V>(x + off, L, s, out + off);
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

// The runs a short row's lane takes: of kShortRuns4 (V 4) or kShortRuns1,
// with G = ceil(L / (V R)) <= 32 lanes a row, the R that gives the most
// digits a warp for each digit a lane holds, (32 / G) * L / R; the first on
// a tie.  On the card two runs a lane beat one and four at L 32 and 64,
// three win at L 48 and 72 (PERF.md section 6, PR 10).
constexpr int kShortRuns4[] = {2, 3, 4, 1};
constexpr int kShortRuns1[] = {1, 2, 4, 8, 16};

inline int short_runs(int L, int V) {
  const int* runs = V == 4 ? kShortRuns4 : kShortRuns1;
  const int n = V == 4 ? 4 : 5;
  int best = 0, best_rpw = 0;
  for (int k = 0; k < n; ++k) {
    const int G = (L + V * runs[k] - 1) / (V * runs[k]);
    if (G > 32) continue;
    const int rpw = 32 / G;
    if (best == 0 || rpw * best > best_rpw * runs[k]) {   // rpw / R > best_rpw / best
      best = runs[k];
      best_rpw = rpw;
    }
  }
  return best;
}

template <int V, int R>
int launch_short(const void* x, void* out, long long B, int L, int s, cudaStream_t stream) {
  const int G = (L + V * R - 1) / (V * R);
  const int rpw = 32 / G;
  const long long per = static_cast<long long>(kWarps) * rpw;
  const long long grid = (B + per - 1) / per;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  normmod_short_kernel<V, R><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const int*>(x), static_cast<int*>(out), B, L, s, G, rpw);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_block(const void* x, void* out, long long B, int L, int s, cudaStream_t stream) {
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  normmod_block_kernel<V><<<static_cast<unsigned>(B), mf::block_row_threads(L), 0, stream>>>(
      static_cast<const int*>(x), static_cast<int*>(out), L, s);
  return static_cast<int>(cudaGetLastError());
}

int launch_long(const void* x, void* out, void* scratch, long long B, int L, int s,
                cudaStream_t stream) {
  const long long W = 16LL * L;
  const int neg = s >= W;
  const int r = static_cast<int>(neg ? s - W : s);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int* s1 = static_cast<int*>(scratch);
  normmod_long_kernel<<<static_cast<unsigned>(B), kLongThreads, 0, stream>>>(
      static_cast<const int*>(x), static_cast<int*>(out), s1, s1 + B * L, L, r >> 4, r & 15,
      neg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows up to these lengths take the short-row and the block-row kernel;
// longer ones stream through `scratch`.
MF_EXPORT int mf_normmod_short_max() { return kShortMaxL; }
MF_EXPORT int mf_normmod_row_max() { return kRowMaxL; }

// x, out: B rows of L digits; scratch: 2 * B * L ints when L >
// mf_normmod_row_max(), else unused; s: the shift exponent in [0, 2W).
MF_EXPORT int mf_normmod(const void* x, void* out, void* scratch, long long B, int L, int s,
                         void* stream) {
  const long long W = 16LL * L;
  if (L < 1 || s < 0 || s >= 2 * W) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L > kRowMaxL) return launch_long(x, out, scratch, B, L, s, st);
  const int V = mf::run_width(L, x, out);
  if (L > kShortMaxL)
    return V == 4 ? launch_block<4>(x, out, B, L, s, st) : launch_block<1>(x, out, B, L, s, st);
  switch (V * 100 + short_runs(L, V)) {
    case 402: return launch_short<4, 2>(x, out, B, L, s, st);
    case 403: return launch_short<4, 3>(x, out, B, L, s, st);
    case 404: return launch_short<4, 4>(x, out, B, L, s, st);
    case 401: return launch_short<4, 1>(x, out, B, L, s, st);
    case 101: return launch_short<1, 1>(x, out, B, L, s, st);
    case 102: return launch_short<1, 2>(x, out, B, L, s, st);
    case 104: return launch_short<1, 4>(x, out, B, L, s, st);
    case 108: return launch_short<1, 8>(x, out, B, L, s, st);
    default: return launch_short<1, 16>(x, out, B, L, s, st);
  }
}
