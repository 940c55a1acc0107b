// Exact non-modular carry canonicalization of long nonnegative digit vectors.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_canonicalize_plain (fused.py:574;
// its kernel_a and kernel_b, :641 and :702, and the host scan between
// them).  Plain version: ops/fused.py canonicalize_plain_torch.  The output
// is canonical, so it is bit-exact against the JAX result.
//
// Input (Bt, N) int32, digits in [0, 2^20), every row an independent vector
// whose value fits it; output canonical digits in [0, 2^16).  Carries never
// cross rows (fused.py:655-681).  Three launches:
//   A  per tile of T digits: two carry passes (digits now <= 2^16 + 2^4; the
//      carries out of the tile's top, t, go to the next tile's digit 0) and
//      the tile's binary carry summary (g, p) over digits 1..T-1;
//   S  per row, one CTA: fold t into each tile's digit 0, compose that
//      digit with the summary, and scan the tiles' (g, p): rc = the exact
//      carry into each tile;
//   C  per tile: the in-tile (g, p) scan seeded with rc, out = (y + cin)
//      mod 2^16.
// After the two passes every digit + carry is < 2^17, so carries are binary
// and (g, p) = (d >> 16, d mod 2^16 == 0xffff) is exact.
//
// What bounds it on an H100: device memory -- about three reads and two
// writes of the vector (A reads x and writes y, C reads y and writes out).
// Design: T = 2048 digits per CTA (256 threads x 8 contiguous digits, kept
// in shared memory); within a tile, each thread composes its 8 digits and a
// block scan over the 256 thread summaries seeds them.  The tile size is
// this card's choice: small enough for many CTAs per SM, large enough that
// the per-row scan of S stays short (1221 tiles at 2.5 M digits).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;
constexpr int kTile = kThreads * kPer;
constexpr int kScanThreads = 1024;

struct GP {
  int g, p;  // carry out = g | (p & carry in)
};

// (high o low): the summary of a low range followed by a high range
__device__ __forceinline__ GP gp_then(GP low, GP high) {
  return {high.g | (high.p & low.g), high.p & low.p};
}

__device__ __forceinline__ GP gp_digit(int d) {
  return {d >> mf::DIGIT_BITS, (d & mf::DIGIT_MASK) == mf::DIGIT_MASK};
}

// inclusive block scan of one GP per thread (Hillis-Steele, ping-pong smem)
template <int NT>
__device__ GP block_scan(GP v, GP* buf) {
  GP* src = buf;
  GP* dst = buf + NT;
  src[threadIdx.x] = v;
  __syncthreads();
  for (int off = 1; off < NT; off <<= 1) {
    dst[threadIdx.x] = threadIdx.x >= off ? gp_then(src[threadIdx.x - off], src[threadIdx.x])
                                          : src[threadIdx.x];
    __syncthreads();
    GP* t = src;
    src = dst;
    dst = t;
  }
  return src[threadIdx.x];
}

// exclusive block scan: the summary of all lower threads' ranges
template <int NT>
__device__ GP block_exclusive(GP v, GP* buf) {
  const GP incl = block_scan<NT>(v, buf);
  __syncthreads();
  buf[threadIdx.x] = incl;
  __syncthreads();
  return threadIdx.x > 0 ? buf[threadIdx.x - 1] : GP{0, 1};
}

__global__ void __launch_bounds__(kThreads)
canon_tiles(const int* __restrict__ x, int* __restrict__ y, int* __restrict__ t,
            int* __restrict__ G, int* __restrict__ P, long long N, long long R) {
  __shared__ int s[kTile];
  __shared__ int c[kTile];
  __shared__ GP scan[2 * kThreads];
  const long long tile = blockIdx.x;
  const long long row = tile / R;
  const long long base = (tile - row * R) * kTile;
  const int* xr = x + row * N;
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    s[i] = base + i < N ? xr[base + i] : 0;
  __syncthreads();
  int tcar = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = threadIdx.x; i < kTile; i += kThreads) c[i] = s[i] >> mf::DIGIT_BITS;
    __syncthreads();
    tcar += c[kTile - 1];
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      s[i] = (s[i] & mf::DIGIT_MASK) + (i ? c[i - 1] : 0);
    __syncthreads();
  }
  int* yt = y + tile * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) yt[i] = s[i];
  // summary of digits 1..T-1 (digit 0 enters as the identity: it still
  // receives the previous tile's t)
  GP v{0, 1};
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x * kPer + u;
    if (i) v = gp_then(v, gp_digit(s[i]));
  }
  const GP all = block_scan<kThreads>(v, scan);
  if (threadIdx.x == kThreads - 1) {
    G[tile] = all.g;
    P[tile] = all.p;
    t[tile] = tcar;
  }
}

__global__ void __launch_bounds__(kScanThreads)
canon_scan(const int* __restrict__ y, const int* __restrict__ t, const int* __restrict__ G,
           const int* __restrict__ P, int* __restrict__ rc, long long R) {
  __shared__ GP scan[2 * kScanThreads];
  const long long row = blockIdx.x;
  const long long chunk = (R + kScanThreads - 1) / kScanThreads;
  const long long lo = threadIdx.x * chunk;
  const long long hi = lo + chunk < R ? lo + chunk : R;
  // whole-tile transition: digit 0 (with the previous tile's t) then the rest
  auto tile_gp = [&](long long r) {
    const long long idx = row * R + r;
    const int y0 = y[idx * kTile] + (r > 0 ? t[idx - 1] : 0);
    return gp_then(gp_digit(y0), GP{G[idx], P[idx]});
  };
  GP v{0, 1};
  for (long long r = lo; r < hi; ++r) v = gp_then(v, tile_gp(r));
  // carry into this thread's first tile: the lower tiles' summary at carry-in 0
  int carry = block_exclusive<kScanThreads>(v, scan).g;
  for (long long r = lo; r < hi; ++r) {
    rc[row * R + r] = carry;
    const GP tr = tile_gp(r);
    carry = tr.g | (tr.p & carry);
  }
}

__global__ void __launch_bounds__(kThreads)
canon_apply(const int* __restrict__ y, const int* __restrict__ t, const int* __restrict__ rc,
            int* __restrict__ out, long long N, long long R) {
  __shared__ int s[kTile];
  __shared__ GP scan[2 * kThreads];
  const long long tile = blockIdx.x;
  const long long row = tile / R;
  const long long r = tile - row * R;
  const long long base = r * kTile;
  const int* yt = y + tile * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) s[i] = yt[i];
  __syncthreads();
  if (threadIdx.x == 0 && r > 0) s[0] += t[tile - 1];
  __syncthreads();
  GP v{0, 1};
  for (int u = 0; u < kPer; ++u) v = gp_then(v, gp_digit(s[threadIdx.x * kPer + u]));
  const GP ex = block_exclusive<kThreads>(v, scan);
  int carry = ex.g | (ex.p & rc[tile]);
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x * kPer + u;
    const int d = s[i];
    s[i] = (d + carry) & mf::DIGIT_MASK;
    carry = (d >> mf::DIGIT_BITS) | (((d & mf::DIGIT_MASK) == mf::DIGIT_MASK) & carry);
  }
  __syncthreads();
  int* outr = out + row * N;
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    if (base + i < N) outr[base + i] = s[i];
}

}  // namespace

MF_EXPORT int mf_canonicalize_tile() { return kTile; }

MF_EXPORT int mf_canonicalize(const void* x, void* out, void* y, void* t, void* g, void* p,
                              void* rc, long long Bt, long long N, long long R, void* stream) {
  if (R != (N + kTile - 1) / kTile) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = Bt * R;
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* yy = static_cast<int*>(y);
  int* tt = static_cast<int*>(t);
  int* rr = static_cast<int*>(rc);
  canon_tiles<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const int*>(x), yy, tt, static_cast<int*>(g), static_cast<int*>(p), N, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  canon_scan<<<static_cast<unsigned>(Bt), kScanThreads, 0, st>>>(
      yy, tt, static_cast<const int*>(g), static_cast<const int*>(p), rr, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  canon_apply<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(yy, tt, rr,
                                                                static_cast<int*>(out), N, R);
  return static_cast<int>(cudaGetLastError());
}
