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
//     2^30 bits, L = 2^18..2^26, up to mf_normmod_long_max() = 2^30 digits
//     (the shift and 2W in 64 bits, digit indices in ints) -- a
//     single-pass chained scan over the card:
//     normmod_chained_kernel, one CTA of kThreads a tile of kTile digits, 8
//     digits a thread in registers, the tile taken from an atomic ticket in
//     row-major order over every row's tiles, so every tile a look-back
//     waits on has started.  A thread builds its digits and the two below
//     them (mod L: a row's first tile reads the row's top digits) with the
//     shift and both carry passes (mf::carried_digits: digits in [-1,
//     2^16]), then its exact carries from carry in 0 and their transition
//     (mf::canon_code), as the block rows do; the CTA composes the
//     transitions by warp shuffles and one round through shared memory.
//     The carries are ternary, {-1, 0, 1}, where csrc/canonicalize.cu's are
//     binary.  The carry into a tile is 0 at a row's first tile; else warp 0
//     also builds the kProbeDigits * 32 digits below the tile (the probe,
//     6% more reads): where their transition is constant (a digit in [1,
//     2^16 - 2] maps every carry in to 0) it is the carry, known with no
//     wait; else decoupled look-back (Merrill & Garland, NVIDIA 2016) over
//     status words that hold a tile's transition (kAggregate) or its
//     inclusive carry as a constant transition (kInclusive), 32 at a time,
//     composed by a warp scan in which the nearest inclusive word ends the
//     chain.  The row's carry out c folds back at digit 0 as -c (2^W ==
//     -1): each tile records, by atomicMax of L - i, its first output
//     digit i that is not 0xFFFF and the first that is not 0 (two words a
//     row); normmod_fold_kernel, a second launch, rewrites only digits [0,
//     f] of each row whose c is not 0, f the first that stops the ripple
//     (the whole row into the -1 form where none does).  The status words,
//     the ticket and the row words are the only scratch
//     (mf_normmod_scratch(B, L) ints), zeroed by normmod_reset_kernel in
//     the same entry point.
// The kernels choose their layout from L and the rows' alignment
// (mf::run_width, short_runs, mf::block_row_threads).
#include "normmod_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kShortMaxL = 512;
constexpr int kRowMaxL = 8192;
constexpr int kBlockMaxThreads = 1024;
// digit indices are ints: i0 + kTile stays below 2^31 (s and W are 64-bit)
constexpr int kMaxL = 1 << 30;
constexpr int kTile = kThreads * mf::kBlockDigits;    // a long row's tile: 2048 digits
constexpr int kProbeDigits = 4;                       // a lane of warp 0, below a tile
constexpr int kFoldCTAs = 64;                         // a row's CTAs in the fold, at most

// status words of the chained scan: 0 not yet published, kAggregate | the
// tile's transition, or kInclusive | the constant transition of its carry
// out (the code's bytes use bits 0-1 each: kCodeBits)
constexpr int kAggregate = 4;
constexpr int kInclusive = 8;
constexpr int kCodeBits = 0x03030303;

// rpw rows of G lanes in each warp of kThreads; row = (block * kWarps +
// warp) * rpw + lane / G.
template <int V, int R>
__global__ void __launch_bounds__(kThreads)
normmod_short_kernel(const int* __restrict__ x, int* __restrict__ out, long long B, int L,
                     long long s, int G, int rpw) {
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
normmod_block_kernel(const int* __restrict__ x, int* __restrict__ out, int L, long long s) {
  const long long off = static_cast<long long>(blockIdx.x) * L;
  mf::normmod_row<V, mf::kBlockDigits / V>(x + off, L, s, out + off);
}

// Inclusive scan of the lanes' transitions, lane 0 the earliest.  Every
// lane of the warp calls it.
__device__ __forceinline__ int warp_scan(int code) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int c = __shfl_up_sync(mf::kFullMask, code, off);
    if (lane >= off) code = mf::code_then(code, c);
  }
  return code;
}

// f(-1) == f(0) == f(1): the range's carry out does not depend on its carry in
__device__ __forceinline__ bool is_constant(int code) { return code == (code & 0xFF) * 0x01010101; }

// The carry into tile k from the status words of the tiles first .. k-1 of
// its row (tile first publishes an inclusive word, with no wait): windows
// of 32 words, nearest first, each waited for until every word is
// published and composed by a warp scan; an inclusive word is a constant
// transition, so the window that holds one gives the carry.  One warp
// calls it.
__device__ __forceinline__ int look_back(const int* status, long long k, long long first) {
  const int lane = threadIdx.x & 31;
  int acc = mf::kCodeIdentity;             // the tiles above the window, up to k-1
  for (long long hi = k - 1;; hi -= 32) {
    const long long j = hi - 31 + lane;
    int w = mf::kCodeIdentity;
    if (j >= first) {
      const volatile int* p = status + j;
      do {
        w = *p;
      } while (w == 0);
    }
    acc = mf::code_then(acc, __shfl_sync(mf::kFullMask, warp_scan(w & kCodeBits), 31));
    if (__any_sync(mf::kFullMask, w & kInclusive)) return mf::code_carry0(acc);
  }
}

// Long rows: one CTA a tile, taken by ticket.  Tile k of the B * R is the
// digits from (k mod R) * kTile of row k / R, thread t the kBlockDigits
// of them from t * kBlockDigits; warp 0 also builds the probe, the 32 *
// kProbeDigits digits below the tile.  scratch[0]: the ticket; then the
// B * R status words; then two words a row, L - i for the first output
// digit i that is not 0xFFFF and for the first that is not 0 (0: none),
// each the largest a tile recorded by atomicMax -- only where it raises
// the words as the CTA read them when it started (they only grow, so a
// tile after the row's first stop records nothing).
template <int V>
__global__ void __launch_bounds__(kThreads)
normmod_chained_kernel(const int* __restrict__ x, int* __restrict__ out, int* scratch,
                       long long B, int L, long long s, int R) {
  constexpr int D = mf::kBlockDigits;
  __shared__ int warp_code[kWarps], warp_before[kWarps], tile_cin, seen[2];
  __shared__ int warp_first[2][kWarps];
  __shared__ long long ticket;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) ticket = atomicAdd(scratch, 1);
  __syncthreads();
  int* const status = scratch + 1;
  const long long k = ticket, row = k / R, first = row * R;
  const int j = static_cast<int>(k - first);
  const int i0 = j * kTile + t * D;
  const int* xr = x + row * L;
  int* const firsts = status + B * R + 2 * row;
  int seen0 = 0, seen1 = 0;
  if (t == 0) {
    seen0 = *static_cast<volatile int*>(firsts);
    seen1 = *static_cast<volatile int*>(firsts + 1);
  }
  int v[D];
  mf::carried_digits<V, D>(xr, i0, s, L, v);
  int probe = 0;
  if (warp == 0 && j > 0) {
    const int pj = j * kTile - 32 * kProbeDigits + lane * kProbeDigits;
    int p[kProbeDigits];
    mf::carried_digits<V, kProbeDigits>(xr, pj, s, L, p);
    probe = __shfl_sync(mf::kFullMask,
                        warp_scan(mf::runs_code<V, kProbeDigits / V>(p, pj, L)), 31);
  }
  const int code = warp_scan(mf::canon_code<V, D / V>(v, i0, L));
  if (lane == 31) warp_code[warp] = code;
  __syncthreads();
  if (warp == 0) {
    const int wc = warp_scan(lane < kWarps ? warp_code[lane] : mf::kCodeIdentity);
    const int tile = __shfl_sync(mf::kFullMask, wc, 31);
    const int below = __shfl_up_sync(mf::kFullMask, wc, 1);
    if (lane < kWarps) warp_before[lane] = lane == 0 ? mf::kCodeIdentity : below;
    volatile int* mine = status + k;
    int cin;
    if (j == 0 || is_constant(probe)) {     // no wait
      cin = j == 0 ? 0 : mf::code_carry0(probe);
    } else {                                // publish the transition, look back
      if (lane == 0) *mine = (is_constant(tile) ? kInclusive : kAggregate) | tile;
      cin = look_back(status, k, first);
    }
    if (lane == 0) {
      const int c = mf::code_apply(tile, cin);
      *mine = kInclusive | mf::code_pack(c, c, c);
      tile_cin = cin;
      seen[0] = seen0;
      seen[1] = seen1;
    }
  }
  __syncthreads();
  int before = __shfl_up_sync(mf::kFullMask, code, 1);
  if (lane == 0) before = mf::kCodeIdentity;
  mf::apply_carries(v, mf::code_apply(mf::code_then(before, warp_before[warp]), tile_cin));
  mf::store_runs<V, D / V, true>(out + row * L, i0, L, v);
  // the first digits that stop a +1 ripple (not 0xFFFF) and a -1 (not 0)
  int nf = L, nz = L;
#pragma unroll
  for (int q = D - 1; q >= 0; --q) {
    if (i0 + q < L) {
      if (v[q] != mf::DIGIT_MASK) nf = i0 + q;
      if (v[q] != 0) nz = i0 + q;
    }
  }
  nf = __reduce_min_sync(mf::kFullMask, nf);
  nz = __reduce_min_sync(mf::kFullMask, nz);
  if (lane == 0) {
    warp_first[0][warp] = nf;
    warp_first[1][warp] = nz;
  }
  __syncthreads();
  if (t < 2) {
    int f = L;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) f = min(f, warp_first[t][w]);
    if (L - f > seen[t]) atomicMax(firsts + t, L - f);
  }
}

// r - c (mod p) on each row whose carry out c (its last tile's inclusive
// word) is not 0: digits [0, f] rewritten, f the first that stops the
// ripple (the row words), the whole row into the -1 form where none does.
// G CTAs a row, a stride over [0, f].
__global__ void __launch_bounds__(kThreads)
normmod_fold_kernel(int* __restrict__ out, const int* __restrict__ scratch, long long B, int L,
                    int R, int G) {
  const long long row = blockIdx.x / G;
  const int part = static_cast<int>(blockIdx.x - row * G);
  const int* status = scratch + 1;
  const int c = mf::code_carry0(status[(row + 1) * R - 1] & kCodeBits);
  if (c == 0) return;
  const int f = L - status[B * R + 2 * row + (c < 0 ? 0 : 1)];
  const int n = f == L ? L : f + 1;
  int* o = out + row * L;
  for (int i = part * kThreads + threadIdx.x; i < n; i += G * kThreads)
    o[i] = f == L ? (i == 0 ? -1 : 0) : i < f ? (c < 0 ? 0 : mf::DIGIT_MASK) : o[i] - c;
}

__global__ void normmod_reset_kernel(int* scratch, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    scratch[i] = 0;
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
int launch_short(const void* x, void* out, long long B, int L, long long s, cudaStream_t stream) {
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
int launch_block(const void* x, void* out, long long B, int L, long long s, cudaStream_t stream) {
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  normmod_block_kernel<V><<<static_cast<unsigned>(B), mf::block_row_threads(L), 0, stream>>>(
      static_cast<const int*>(x), static_cast<int*>(out), L, s);
  return static_cast<int>(cudaGetLastError());
}

long long tiles_per_row(int L) { return (L + kTile - 1) / kTile; }

template <int V>
int launch_long(const void* x, void* out, int* scratch, long long B, int L, long long s,
                cudaStream_t stream) {
  const long long R = tiles_per_row(L), tiles = B * R, n = tiles + 2 * B + 1;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  normmod_reset_kernel<<<static_cast<unsigned>((n + 1023) / 1024 < 264 ? (n + 1023) / 1024 : 264),
                         1024, 0, stream>>>(scratch, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  normmod_chained_kernel<V><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const int*>(x), static_cast<int*>(out), scratch, B, L, s, static_cast<int>(R));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = static_cast<int>(R < kFoldCTAs ? R : kFoldCTAs);
  normmod_fold_kernel<<<static_cast<unsigned>(B * G), kThreads, 0, stream>>>(
      static_cast<int*>(out), scratch, B, L, static_cast<int>(R), G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows up to these lengths take the short-row and the block-row kernel;
// longer ones the chained scan.
MF_EXPORT int mf_normmod_short_max() { return kShortMaxL; }
MF_EXPORT int mf_normmod_row_max() { return kRowMaxL; }
// The longest row the chained scan takes.
MF_EXPORT int mf_normmod_long_max() { return kMaxL; }

// Ints of scratch mf_normmod needs for B rows of L digits (0: none): the
// long route's ticket, status words and row words.
MF_EXPORT long long mf_normmod_scratch(long long B, int L) {
  return L <= kRowMaxL ? 0 : B * tiles_per_row(L) + 2 * B + 1;
}

// x, out: B rows of L digits (L <= mf_normmod_long_max()); scratch:
// mf_normmod_scratch(B, L) ints (scratch_ints of them), or null where that
// is 0; s: the shift exponent in [0, 2W).
MF_EXPORT int mf_normmod(const void* x, void* out, void* scratch, long long scratch_ints,
                         long long B, int L, long long s, void* stream) {
  const long long W = 16LL * L;
  if (B < 0 || L < 1 || L > kMaxL || s < 0 || s >= 2 * W ||
      scratch_ints < mf_normmod_scratch(B, L) || (L > kRowMaxL && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = mf::run_width(L, x, out);
  if (L > kRowMaxL) {
    int* sc = static_cast<int*>(scratch);
    return V == 4 ? launch_long<4>(x, out, sc, B, L, s, st) : launch_long<1>(x, out, sc, B, L, s, st);
  }
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
