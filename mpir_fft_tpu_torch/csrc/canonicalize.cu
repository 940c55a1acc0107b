// Exact non-modular carry canonicalization of nonnegative digit vectors, in
// one pass: one read and one write a digit.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_canonicalize_plain (fused.py:574;
// its kernel_a and kernel_b, :641 and :702, and the host scan between
// them).  Plain version: ops/fused.py canonicalize_plain_torch.  The output
// is canonical, so it is bit-exact against the JAX result.
//
// Input (Bt, N) int32, digits in [0, 2^20), every row an independent vector
// whose value fits it; output canonical digits in [0, 2^16).  The top carry
// is dropped and carries never cross rows (fused.py:655-681).  Two carry
// passes leave every digit in [0, 2^16], so the exact carries are binary:
// a run of digits either kills, generates or propagates its carry in, and
// the carry into a digit is the carry out of the nearest run below it that
// does not propagate (0 where none does).  After the two passes digit i
// depends only on x[i-2..i], so a thread recomputes the two digits below its
// run and needs no exchange before the scan.
//
// What bounds it on an H100: device memory, 8 bytes a digit (x read once,
// out written once).  A thread holds kPer = 8 consecutive digits in
// registers.  Runs sit on 16-byte boundaries of the flat buffer (a row that
// starts mid-chunk gives its first thread a short run), so a run inside the
// row is two int4 loads and two int4 stores with the streaming hint (evict
// first: each digit is touched once; on the card it beat plain loads and
// stores, and 8 digits a thread beat 16); the row's two end runs go word
// by word.  Where x and out differ in alignment
// mod 16 bytes, every run goes word by word (V = 1; the wrapper's own output
// is aligned, so the main path takes V = 4).  The scan inside a CTA is a
// ballot over a warp's runs, then one over the <= 32 warp totals through
// shared memory.  The route is chosen here, from N:
//   * rows, N <= kRowMax (the recursive pointwise's combines, (6528, 5169)
//     and (5376, 6209) at 1.2 / 1.5x10^9 bits): canon_row_kernel, one CTA a
//     row, one barrier;
//   * longer rows (the final product of every mul, 10^5-10^8 digits):
//     canon_chained_kernel, a single-pass chained scan with decoupled
//     look-back (Merrill & Garland, NVIDIA 2016) over tiles of kTile digits,
//     one CTA a tile.  A CTA takes its tile from an atomic ticket, so every
//     tile it waits on has started.  Warp 0 also loads the probe, the 128
//     digits below the tile (6% more reads): where those absorb, their
//     carry out is the tile's carry in, known with no wait.  Only where the
//     probe propagates does warp 0 look back: it publishes the tile's
//     transition (its inclusive carry at once where the tile kills or
//     generates, else the flag "propagates"), reads the 32 status words
//     below the tile until an inclusive one, and publishes the tile's
//     inclusive carry.  Every tile publishes an inclusive carry either way.
//     A look-back on every tile was slower on random digits (it waits for
//     the tile below to load); the all-0xFFFF ripple still takes it on
//     every tile.  A row's first tile starts from carry 0, so no look-back
//     crosses a row.  The status words and the ticket are the only scratch
//     (Bt * R + 1 ints, R tiles a row); canon_reset_kernel zeroes them in
//     the same entry point, a second launch of each call (no epoch tags).
#include "normmod_row.cuh"

namespace {

constexpr int kPer = 8;                                     // digits a thread
constexpr int kRowMax = 8192;
constexpr int kLongThreads = 256;
constexpr int kTile = kLongThreads * kPer;                  // 2048 digits
constexpr int kProbeDigits = 4;                             // a lane, below a tile

// a run's transition as a code: bit 1 set where it kills or generates (its
// carry out, bit 0, does not depend on its carry in); 0 where it propagates
constexpr int kAbsorbs = 2;
// status words of the chained scan: 0 not yet published, kPropagates, or
// kInclusive | carry << 2 (the exact carry out of the tile)
constexpr int kPropagates = 1;
constexpr int kInclusive = 2;

// The carry out of lanes 0..31's runs in order (code as above; lanes past
// the end hold 0) from carry in cin.  Every lane of the warp calls it.
__device__ __forceinline__ int carry_through(int code, int cin) {
  const unsigned stop = __ballot_sync(mf::kFullMask, code & kAbsorbs);
  const int top = __shfl_sync(mf::kFullMask, code, stop ? 31 - __clz(stop) : 0);
  return stop ? top & 1 : cin;
}

// Digits j0 .. j0+D-1 of the row xr, 0 outside [0, N).  V == 4: xr + j0 is
// 16-byte aligned, and a run inside the row is D / 4 streaming int4 loads.
template <int V, int D>
__device__ __forceinline__ void load_digits(const int* xr, long long j0, long long N,
                                            int (&v)[D]) {
  if (V == 4 && j0 >= 0 && j0 + D <= N) {
#pragma unroll
    for (int q = 0; q < D; q += 4) {
      const int4 c = __ldcs(reinterpret_cast<const int4*>(xr + j0 + q));
      v[q] = c.x;
      v[q + 1] = c.y;
      v[q + 2] = c.z;
      v[q + 3] = c.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < D; ++u) v[u] = j0 + u >= 0 && j0 + u < N ? xr[j0 + u] : 0;
  }
}

template <int V, int D>
__device__ __forceinline__ void store_digits(int* outr, long long j0, long long N,
                                             const int (&v)[D]) {
  if (V == 4 && j0 >= 0 && j0 + D <= N) {
#pragma unroll
    for (int q = 0; q < D; q += 4)
      __stcs(reinterpret_cast<int4*>(outr + j0 + q),
             make_int4(v[q], v[q + 1], v[q + 2], v[q + 3]));
  } else {
#pragma unroll
    for (int u = 0; u < D; ++u)
      if (j0 + u >= 0 && j0 + u < N) outr[j0 + u] = v[u];
  }
}

// The carry into a tile from the status words of the tiles first .. tile-1
// of its row (tile first has published an inclusive carry, or will): lane
// 31 reads the nearest, each window of 32 words waits until all are
// published, the nearest inclusive one decides.  One warp calls it.
__device__ __forceinline__ int look_back(const int* status, long long tile, long long first) {
  const int lane = threadIdx.x & 31;
  for (long long hi = tile - 1;; hi -= 32) {
    const long long j = hi - 31 + lane;
    int w = kPropagates;
    if (j >= first) {
      const volatile int* s = status + j;
      do {
        w = *s;
      } while (w == 0);
    }
    const unsigned inc = __ballot_sync(mf::kFullMask, w & kInclusive);
    const int top = __shfl_sync(mf::kFullMask, w, inc ? 31 - __clz(inc) : 0);
    if (inc) return (top >> 2) & 1;
  }
}

// The two input digits below digit j0 of the row xr (0 below the row).
__device__ __forceinline__ void load_halo(const int* xr, long long j0, long long N, int& u2,
                                          int& u1) {
  u2 = j0 >= 2 && j0 - 2 < N ? xr[j0 - 2] : 0;
  u1 = j0 >= 1 && j0 - 1 < N ? xr[j0 - 1] : 0;
}

// The run of thread t: its D digits v as loaded, (u2, u1) the two input
// digits below it on lane 0 (load_halo; the lane below holds them for the
// others).  Carries v twice and returns the warp's transition code; stop /
// gen: the warp's ballots of runs that absorb / that carry out 1.  Every
// lane of the warp calls it.
template <int D>
__device__ __forceinline__ int carry_run(int (&v)[D], int u2, int u1, unsigned& stop,
                                         unsigned& gen) {
  const int lane = threadIdx.x & 31;
  const int b2 = __shfl_up_sync(mf::kFullMask, v[D - 2], 1);
  const int b1 = __shfl_up_sync(mf::kFullMask, v[D - 1], 1);
  if (lane) {
    u2 = b2;
    u1 = b1;
  }
  // two carry passes (no wrap: i0 1), the second seeded with the first
  // pass's digit below the run
  mf::carry_digits(v, u1, 1);
  mf::carry_digits(v, (u1 & mf::DIGIT_MASK) + (u2 >> mf::DIGIT_BITS), 1);
  // the run's transition: its carry out from carry in 0 and from 1
  int c0 = 0, c1 = 1;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    c0 = (v[j] + c0) >> mf::DIGIT_BITS;
    c1 = (v[j] + c1) >> mf::DIGIT_BITS;
  }
  const int code = c0 == c1 ? kAbsorbs | c0 : 0;
  stop = __ballot_sync(mf::kFullMask, code & kAbsorbs);
  gen = __ballot_sync(mf::kFullMask, code & 1);
  return stop ? kAbsorbs | ((gen >> (31 - __clz(stop))) & 1) : 0;
}

// Exact carries of a carried run from the CTA's carry in cin, the warp
// codes of the warps below (warp_code, after a barrier) and the warp's
// ballots, then the write.  Every lane of the warp calls it.
template <int V, int D>
__device__ __forceinline__ void finish_run(int (&v)[D], int* outr, long long j0, long long N,
                                           int cin, const int* warp_code, unsigned stop,
                                           unsigned gen) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cin = carry_through(lane < warp ? warp_code[lane] : 0, cin);     // into this warp
  const unsigned below = stop & ((1u << lane) - 1);
  if (below) cin = (gen >> (31 - __clz(below))) & 1;               // into this run
  mf::apply_carries(v, cin);
  store_digits<V, D>(outr, j0, N, v);
}

// Row route: one CTA a row, digit j at position j + a (a = the row start's
// word offset in its 16-byte chunk where V == 4, else 0), thread t the
// kPer positions from t * kPer.
template <int V>
__global__ void __launch_bounds__(1024)
canon_row_kernel(const int* __restrict__ x, int* __restrict__ out, long long N, int phase) {
  __shared__ int warp_code[32];
  const long long row = blockIdx.x;
  const int a = V == 4 ? static_cast<int>((phase + row * N) & 3) : 0;
  const int* xr = x + row * N;
  const long long j0 = static_cast<long long>(threadIdx.x) * kPer - a;
  int v[kPer], u2 = 0, u1 = 0;
  unsigned stop, gen;
  load_digits<V>(xr, j0, N, v);
  if ((threadIdx.x & 31) == 0) load_halo(xr, j0, N, u2, u1);
  const int code = carry_run(v, u2, u1, stop, gen);
  if ((threadIdx.x & 31) == 0) warp_code[threadIdx.x >> 5] = code;
  __syncthreads();
  finish_run<V>(v, out + row * N, j0, N, 0, warp_code, stop, gen);
}

// Chained route: one CTA a tile, taken by ticket.  Tile k of the Bt * R is
// the digits from (k mod R) * kTile - a of row k / R (a as above), thread t
// kPer of them from t * kPer; warp 0 also holds the probe,
// the 32 * kProbeDigits digits below the tile.  scratch[0]: the ticket;
// scratch[1 + k]: the status words.
template <int V>
__global__ void __launch_bounds__(kLongThreads)
canon_chained_kernel(const int* __restrict__ x, int* __restrict__ out, int* scratch, long long N,
                     long long R, int phase) {
  __shared__ int warp_code[32], tile_cin;
  __shared__ long long ticket;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) ticket = atomicAdd(scratch, 1);
  __syncthreads();
  const long long k = ticket, row = k / R, first = row * R;
  const int a = V == 4 ? static_cast<int>((phase + row * N) & 3) : 0;
  const int* xr = x + row * N;
  const long long s = (k - first) * kTile - a;               // the tile's digit 0
  const long long j0 = s + static_cast<long long>(t) * kPer;
  int v[kPer], u2 = 0, u1 = 0;
  load_digits<V>(xr, j0, N, v);
  if (lane == 0) load_halo(xr, j0, N, u2, u1);
  int p[kProbeDigits], p2 = 0, p1 = 0;
  const long long pj = s - 32 * kProbeDigits + lane * kProbeDigits;
  if (warp == 0) {
    load_digits<V>(xr, pj, N, p);
    if (lane == 0) load_halo(xr, pj, N, p2, p1);
  }
  unsigned stop, gen;
  const int code = carry_run(v, u2, u1, stop, gen);
  if (lane == 0) warp_code[warp] = code;
  __syncthreads();
  if (warp == 0) {
    // the tile's carry out where it absorbs, else -1
    const int tout = carry_through(lane < kLongThreads / 32 ? warp_code[lane] : 0, -1);
    unsigned ps, pg;
    const int probe = carry_run(p, p2, p1, ps, pg);
    volatile int* mine = scratch + 1 + k;
    int tc;
    if (probe & kAbsorbs) {               // the probe decides the carry in
      tc = probe & 1;
      if (lane == 0) *mine = kInclusive | ((tout >= 0 ? tout : tc) << 2);
    } else {                              // it propagates: look back
      if (lane == 0) *mine = tout >= 0 ? kInclusive | (tout << 2) : kPropagates;
      tc = k == first ? 0 : look_back(scratch + 1, k, first);
      if (lane == 0 && tout < 0) *mine = kInclusive | (tc << 2);
    }
    if (lane == 0) tile_cin = tc;
  }
  __syncthreads();
  finish_run<V>(v, out + row * N, j0, N, tile_cin, warp_code, stop, gen);
}

__global__ void canon_reset_kernel(int* scratch, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    scratch[i] = 0;
}

// Tiles of a long row: its digits and up to 3 words of alignment offset.
long long tiles_per_row(long long N) { return (N + 3 + kTile - 1) / kTile; }

// Threads of a row-route CTA: the row's positions (up to 3 of offset where
// V == 4) in whole warps.
long long row_threads(long long N, int V) {
  return ((N + (V == 4 ? 3 : 0) + kPer - 1) / kPer + 31) / 32 * 32;
}

template <int V>
int launch(const void* x, void* out, void* scratch, long long Bt, long long N, int phase,
           cudaStream_t st) {
  const int* xx = static_cast<const int*>(x);
  int* oo = static_cast<int*>(out);
  if (N <= kRowMax) {
    if (Bt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    const unsigned threads = static_cast<unsigned>(row_threads(N, V));
    canon_row_kernel<V><<<static_cast<unsigned>(Bt), threads, 0, st>>>(xx, oo, N, phase);
    return static_cast<int>(cudaGetLastError());
  }
  const long long R = tiles_per_row(N);
  const long long tiles = Bt * R;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int* s = static_cast<int*>(scratch);
  const long long n = tiles + 1;
  canon_reset_kernel<<<static_cast<unsigned>((n + 1023) / 1024 < 264 ? (n + 1023) / 1024 : 264),
                       1024, 0, st>>>(s, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  canon_chained_kernel<V><<<static_cast<unsigned>(tiles), kLongThreads, 0, st>>>(xx, oo, s, N, R,
                                                                                phase);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The long route's tile, and the longest row of the row route.
MF_EXPORT int mf_canonicalize_tile() { return kTile; }
MF_EXPORT int mf_canonicalize_row_max() { return kRowMax; }

// Ints of scratch mf_canonicalize needs for Bt rows of N digits (0: none).
MF_EXPORT long long mf_canonicalize_scratch(long long Bt, long long N) {
  return N <= kRowMax ? 0 : Bt * tiles_per_row(N) + 1;
}

// x, out: Bt rows of N digits; scratch: mf_canonicalize_scratch(Bt, N)
// ints (scratch_ints of them), or null where that is 0.  Runs of 4 words
// where x and out share their offset in a 16-byte chunk and, on the row
// route, 1024 threads hold the row's positions (N <= 8189), else of 1.
MF_EXPORT int mf_canonicalize(const void* x, void* out, void* scratch, long long scratch_ints,
                              long long Bt, long long N, void* stream) {
  if (Bt < 0 || N < 0 || scratch_ints < mf_canonicalize_scratch(Bt, N))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Bt == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t px = reinterpret_cast<size_t>(x), po = reinterpret_cast<size_t>(out);
  const int phase = static_cast<int>((px >> 2) & 3);
  const bool wide = px % 16 == po % 16 && (N > kRowMax || row_threads(N, 4) <= 1024);
  return wide ? launch<4>(x, out, scratch, Bt, N, phase, st)
              : launch<1>(x, out, scratch, Bt, N, phase, st);
}
