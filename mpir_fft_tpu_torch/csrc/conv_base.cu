// Schoolbook pointwise product mod 2^(16L)+1, accumulated in fp64.
//
// Replaces: mpir_fft_tpu/ops/pointwise_fused.py mulmod_base_fused /
// _conv_kernel (pointwise_fused.py:77 and :48).  Plain version:
// ops/pointwise.py conv_base_plain (the chunk convolution); the two agree
// after normmod.
//
// Input (B, L) int32 redundant digits a, b; output (B, L) bounded redundant
// digits of a*b mod 2^(16L)+1, each in (-2^6, 2^16 + 2^6).  Per row
//   c_j = sum_i a_i b_(j-i)     (a wrapped term negated: 2^(16L) == -1),
// one DFMA a term.  Exactness: every partial sum is an integer of magnitude
// at most L max|a| max|b|, exact in a double while that stays below 2^53.
// The transforms keep |digit| <= ~2^17 (ops/pointwise.py mulmod_base), so
// at L <= 2048 (2L <= 4096, the rings the schoolbook serves) the sums stay
// below 2^45: room for digits up to 2^20.  Each c_j converts exactly to
// int64 and splits into 16-bit pieces, c_j = c0 + 2^16 c1 + 2^32 c2 (c0, c1
// in [0, 2^16), |c2| < 2^21); then d_j = c0_j + c1_(j-1) + c2_(j-2), a piece
// that crosses digit L-1 negated, and one carry pass (mf::carry_digit's).
// The TPU kernel, limited to int32, splits digits into byte planes and runs
// four multiply-adds a digit product; here it is one.
//
// What bounds it on an H100: L^2 DFMAs a row at 16.7 x 10^12/s against 12
// bytes a digit at 3.35 TB/s -- at the inner rings' L 32-72 the two are
// within 25% of each other.  Design: a lane owns R consecutive outputs in R
// fp64 accumulators, so R outputs share every load.  At step i it needs a_i
// (a broadcast from shared memory) and, as its window of b slides down by
// one digit, the value its left neighbour drops (__shfl_up_sync); the row's
// first lane takes b~_(-i-1) = -b_(L-1-i), the negacyclic wrap, from shared
// memory instead.  The window rotates through registers by renaming (the
// step loop is unrolled by R), so a step is R DFMAs, one shared load, two
// shuffles and a select.  Rows shorter than the lanes' G*R outputs run
// padded steps with a_i = 0.  Two routes, chosen here from L:
//   * short rows, L <= kShortMaxL (the recursive pointwise's inner rings,
//     L 32-72, and the MPIR_FFT_NTT=0 plans' rings up to 512):
//     conv_short_kernel, G = ceil(L / R) <= 32 lanes a row, several rows a
//     warp, each warp its own rows.  A row's step slot holds a_i and the
//     wrap value side by side (one 16-byte broadcast load a step); a warp's
//     rows lie an odd number of slots apart, so they start in distinct
//     banks.  No __syncthreads; __syncwarp around the step loop.
//   * block rows (L up to 2048; only the MPIR_FFT_NTT=0 plans' L 1024 and
//     the tests): conv_block_kernel, one CTA a row, a and b~ = [-b, b] as
//     doubles in shared memory (24 bytes a digit, 48 KB at L 2048), R = 8;
//     each warp's first lane takes its new window value from b~.  These
//     rows are compute-bound.
// R is chosen from L (short_runs); rows with L % 4 == 0 whose tensors are
// 16-byte aligned load and store int4 runs.  On the card the FP64 pipe, not
// the shuffles, the shared loads or the memory, binds the step loop
// (PERF.md section 6).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kShortWarps = 4;
constexpr int kShortMaxL = 512;
constexpr int kBlockRuns = 8;
constexpr int kBlockMaxThreads = 2048 / kBlockRuns;

// acc_r += a_i w_r for i < steps (a multiple of R), the window w sliding one
// digit down a step.  fetch(i) gives (a_i, the value a first lane takes in).
// The logical w_r lives in w[(r - k) mod R] at step k of R: the top one
// leaves for the next lane, and its register takes the new bottom value.
// Every lane of the warp runs it (the shuffle).
template <int R, class Fetch>
__device__ __forceinline__ void conv_steps(double (&acc)[R], double (&w)[R], int steps,
                                           bool first, Fetch fetch) {
  for (int i0 = 0; i0 < steps; i0 += R) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const double2 v = fetch(i0 + k);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fma(v.x, w[(r - k + R) % R], acc[r]);
      const double up = __shfl_up_sync(kFull, w[R - 1 - k], 1);
      w[R - 1 - k] = first ? v.y : up;
    }
  }
}

// A lane's digits j0 .. j0+R-1 of rows ar, br (zero past L or when !live).
template <int R>
__device__ __forceinline__ void load_run(const int* ar, const int* br, int j0, int L, bool live,
                                         bool vec, int (&av)[R], int (&bv)[R]) {
  if constexpr (R % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const bool in = live && j0 + 4 * q < L;
        const int4 x = in ? reinterpret_cast<const int4*>(ar + j0)[q] : make_int4(0, 0, 0, 0);
        const int4 y = in ? reinterpret_cast<const int4*>(br + j0)[q] : make_int4(0, 0, 0, 0);
        av[4 * q] = x.x, av[4 * q + 1] = x.y, av[4 * q + 2] = x.z, av[4 * q + 3] = x.w;
        bv[4 * q] = y.x, bv[4 * q + 1] = y.y, bv[4 * q + 2] = y.z, bv[4 * q + 3] = y.w;
      }
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = live && j0 + r < L;
    av[r] = in ? ar[j0 + r] : 0;
    bv[r] = in ? br[j0 + r] : 0;
  }
}

// Output digits j0 .. j0+R-1 (those below L) of a row from its L exact
// products c (int64, shared memory): the pieces of c_(j0-3) .. c_(j0+R-1),
// then d_(j0-1) .. d_(j0+R-1), then one carry pass.  Positions are taken
// mod L; par is the parity of the wraps of each logical position, and a
// piece or carry whose source and destination parities differ crossed
// digit L-1 an odd number of times: it is negated.
template <int R>
__device__ __forceinline__ void recombine(const long long* c, int L, int j0, int* o, bool vec) {
  long long cc[R + 3];
  int par[R + 3];
  int s = j0 - 3, p = 0;
  while (s < 0) {
    s += L;
    p ^= 1;
  }
#pragma unroll
  for (int u = 0; u < R + 3; ++u) {
    cc[u] = c[s];
    par[u] = p;
    if (++s == L) {
      s = 0;
      p ^= 1;
    }
  }
  int d[R + 1];
#pragma unroll
  for (int t = 0; t <= R; ++t) {
    const int p1 = static_cast<int>((cc[t + 1] >> 16) & mf::DIGIT_MASK);
    const int p2 = static_cast<int>(cc[t] >> 32);
    d[t] = static_cast<int>(cc[t + 2] & mf::DIGIT_MASK) + (par[t + 2] != par[t + 1] ? -p1 : p1) +
           (par[t + 2] != par[t] ? -p2 : p2);
  }
  int res[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int cy = d[r] >> mf::DIGIT_BITS;
    res[r] = (d[r + 1] & mf::DIGIT_MASK) + (par[r + 3] != par[r + 2] ? -cy : cy);
  }
  if constexpr (R % 4 == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q)
        if (j0 + 4 * q < L)
          reinterpret_cast<int4*>(o + j0)[q] =
              make_int4(res[4 * q], res[4 * q + 1], res[4 * q + 2], res[4 * q + 3]);
      return;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (j0 + r < L) o[j0 + r] = res[r];
}

// Short rows: G lanes a row, rpw rows a warp, kShortWarps warps a CTA;
// row = (block * kShortWarps + warp) * rpw + lane / G.  Shared memory: per
// warp rpw rows of S = (G R) | 1 slots (a_i, -b_(L-1-i)), zeros from L to
// G R; after the steps a row's slots hold its products c.
template <int R>
__global__ void __launch_bounds__(kShortWarps * 32)
conv_short_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
                  long long B, int L, int G, int rpw, int vec) {
  extern __shared__ double2 slots[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int Lp = G * R;
  const int slot = lane / G;
  const int j0 = (lane - slot * G) * R;
  const bool held = slot < rpw;
  const long long row = (static_cast<long long>(blockIdx.x) * kShortWarps + warp) * rpw + slot;
  const bool live = held && row < B;
  const long long off = live ? row * L : 0;
  double2* sr = slots + (warp * rpw + (held ? slot : 0)) * (Lp | 1);

  int av[R], bv[R];
  load_run<R>(a + off, b + off, j0, L, live, vec, av, bv);
  double w[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = j0 + r;
    w[r] = static_cast<double>(bv[r]);
    if (held && j < L) {
      sr[j].x = static_cast<double>(av[r]);
      sr[L - 1 - j].y = -w[r];
    } else if (held && j < Lp) {
      sr[j] = make_double2(0.0, 0.0);
    }
    acc[r] = 0.0;
  }
  __syncwarp();
  conv_steps<R>(acc, w, Lp, j0 == 0, [&](int i) { return sr[i]; });
  __syncwarp();
  long long* c = reinterpret_cast<long long*>(sr);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (held && j0 + r < L) c[j0 + r] = __double2ll_rn(acc[r]);
  __syncwarp();
  if (live && j0 < L) recombine<R>(c, L, j0, out + off, vec);
}

// Block rows: one CTA a row, blockDim.x = 32 ceil(G / 32) threads, G =
// ceil(L / R).  Shared memory: A = a (G R doubles, zeros past L; then the
// products c), X[G R + k] = b~_k for k in [-G R, G R) (zeros outside
// [-L, L)).
template <int R>
__global__ void __launch_bounds__(kBlockMaxThreads)
conv_block_kernel(const int* __restrict__ a, const int* __restrict__ b, int* __restrict__ out,
                  int L, int G, int vec) {
  extern __shared__ double sm[];
  const int Lp = G * R;
  double* A = sm;
  double* X = sm + Lp;
  const long long off = static_cast<long long>(blockIdx.x) * L;
  const int t = threadIdx.x;
  for (int k = t; k < Lp; k += blockDim.x) {
    const bool in = k < L;
    const double bk = in ? static_cast<double>(b[off + k]) : 0.0;
    A[k] = in ? static_cast<double>(a[off + k]) : 0.0;
    X[Lp + k] = bk;
    if (in) X[Lp - L + k] = -bk;
    if (k < Lp - L) X[k] = 0.0;
  }
  __syncthreads();
  const int j0 = t * R;
  const int jw = (t & ~31) * R;   // the warp's first output
  double w[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    w[r] = j0 + r < Lp ? X[Lp + j0 + r] : 0.0;
    acc[r] = 0.0;
  }
  conv_steps<R>(acc, w, Lp, (t & 31) == 0,
                [&](int i) { return make_double2(A[i], X[Lp + jw - i - 1]); });
  __syncthreads();
  long long* c = reinterpret_cast<long long*>(A);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (j0 + r < L) c[j0 + r] = __double2ll_rn(acc[r]);
  __syncthreads();
  if (j0 < L) recombine<R>(c, L, j0, out + off, vec);
}

// The outputs a short-row lane owns: of kShortRuns, the R that wastes the
// fewest DFMA slots on padding and idle lanes -- useful FMAs rpw L^2 over
// issued 32 G R^2, rpw = 32 / G rows a warp -- the first on a tie.
constexpr int kShortRuns[] = {12, 8, 16};

inline int short_runs(int L) {
  int best = 0;
  long long best_num = 0, best_den = 1;
  for (int R : kShortRuns) {
    const int G = (L + R - 1) / R;
    if (G > 32) continue;
    const long long num = 32 / G, den = static_cast<long long>(G) * R * R;
    if (best == 0 || num * best_den > best_num * den) {
      best = R;
      best_num = num;
      best_den = den;
    }
  }
  return best;
}

template <int R>
int launch_short(const int* a, const int* b, int* out, long long B, int L, int vec,
                 cudaStream_t stream) {
  const int G = (L + R - 1) / R;
  const int rpw = 32 / G;
  const long long per = static_cast<long long>(kShortWarps) * rpw;
  const long long grid = (B + per - 1) / per;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = sizeof(double2) * kShortWarps * rpw * ((G * R) | 1);
  cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(conv_short_kernel<R>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_short_kernel<R><<<static_cast<unsigned>(grid), kShortWarps * 32, smem, stream>>>(
      a, b, out, B, L, G, rpw, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_block(const int* a, const int* b, int* out, long long B, int L, int vec,
                 cudaStream_t stream) {
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int G = (L + kBlockRuns - 1) / kBlockRuns;
  const size_t smem = 3 * sizeof(double) * G * kBlockRuns;
  cudaError_t err =
      mf::set_smem(reinterpret_cast<const void*>(conv_block_kernel<kBlockRuns>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned threads = static_cast<unsigned>((G + 31) / 32 * 32);
  conv_block_kernel<kBlockRuns><<<static_cast<unsigned>(B), threads, smem, stream>>>(
      a, b, out, L, G, vec);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

}  // namespace

// Rows up to this length take the short-row kernel, longer ones a CTA each.
MF_EXPORT int mf_conv_base_short_max() { return kShortMaxL; }

// a, b, out: B rows of L digits, 2L <= 4096.
MF_EXPORT int mf_conv_base(const void* a, const void* b, void* out, long long B, int L,
                           void* stream) {
  if (L < 1 || 2 * L > 4096) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int* ai = static_cast<const int*>(a);
  const int* bi = static_cast<const int*>(b);
  int* oi = static_cast<int*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = L % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(out);
  if (L > kShortMaxL) return launch_block(ai, bi, oi, B, L, vec, st);
  switch (short_runs(L)) {
    case 16: return launch_short<16>(ai, bi, oi, B, L, vec, st);
    case 12: return launch_short<12>(ai, bi, oi, B, L, vec, st);
    default: return launch_short<8>(ai, bi, oi, B, L, vec, st);
  }
}
