// The exact canonicalization of ring elements, run by run: the row bodies of
// csrc/normmod.cu (its short-row and block-row kernels, and the long rows'
// tiles); the block rows' exact carry (exact_rows) is also the inverse
// sqrt2 top merge's norm tail (csrc/sqrt2_top.cu), on both output rows at
// once.
//
// out = normmod(v * 2^s mod 2^(16L)+1) for a static shift s in [0, 2W): the
// shift (rotation, sub-digit shift, sign: shifted_digits), two carry passes
// (digits now in [-1, 2^16]), then the exact carry: each digit's carry
// transition f(cin) = floor((d + cin) / 2^16) maps {-1,0,1} to {-1,0,1}; an
// inclusive scan composes them, cin_i is the prefix before i evaluated at 0,
// and the row's carry-out c folds back in at digit 0 as -c (2^W == -1) with a
// ripple that keeps the -1 form [-1, 0, ...] (limb.py _normmod_core).
//
// Layout: a thread holds D = V*R consecutive digits in registers (R runs of
// V = 4 digits, read as one window of aligned int4 chunks, where L % 4 == 0
// and the rows are 16-byte aligned; else V = 1: run_width) and runs the
// carry passes, its digits' transitions and their application serially over
// them: O(L) work a row.  Only the passes' first digit and the scan cross
// threads.  Two groupings:
//   * short rows (normmod_short): G = ceil(L / D) <= 32 lanes of a warp a
//     row, several rows a warp.  The carry passes take the digit below a
//     lane's run by __shfl_up_sync, the wrap (digit L-1, its carry negated)
//     from the lane that holds it; the scan is ceil(log2 G) shuffle steps;
//     __ballot_sync / __ffs find the first digit that stops the carry-out's
//     ripple.  No shared memory, no barrier.
//   * block rows (normmod_row): one CTA a row, kBlockDigits = 8 digits a
//     thread in whole warps (block_row_threads).  A thread recomputes the
//     two shifted digits below its run, so the carry passes need no
//     exchange; then exact_rows: a warp-shuffle scan, then one scan of the
//     <= 32 warp totals through shared memory: two barriers, a third only
//     when the carry-out is not 0.  One carry pass would do (its digits'
//     transitions already map {-1,0,1} into itself); the second keeps the
//     reference's sequence.
//
// A transition is a code word of four bytes: byte 0 holds e(f(-1)), bytes 1
// and 2 e(f(0)), byte 3 e(f(1)), with e(-1, 0, 1) = (0, 1, 3) -- each value a
// byte index of the code, so that g o f is one byte permute of g selected by
// f's bytes, compacted to nibbles by f | f >> 12 (code_then).
#pragma once

#include "ladder_group.cuh"

namespace mf {

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kCodeIdentity = 0x03010100;   // f(c) = c

__device__ __forceinline__ int code_byte(int c) {
  const int e = c + 1;
  return e + (e >> 1);
}

// the transition of a digit range from its three carry chains' ends
__device__ __forceinline__ int code_pack(int cm, int c0, int cp) {
  return code_byte(cm) | code_byte(c0) * 0x00010100 | (code_byte(cp) << 24);
}

// later o earlier: the transition of two consecutive digit ranges
__device__ __forceinline__ int code_then(int later, int earlier) {
  const unsigned e = static_cast<unsigned>(earlier);
  return static_cast<int>(__byte_perm(static_cast<unsigned>(later), 0u, e | (e >> 12)));
}

// f(0): the carry out of a range whose carry in is 0
__device__ __forceinline__ int code_carry0(int code) {
  return ((((code >> 8) & 3) + 1) >> 1) - 1;
}

// f(c): the carry out of a range whose carry in is c in {-1, 0, 1}
__device__ __forceinline__ int code_apply(int code, int c) {
  return ((((code >> (8 * code_byte(c))) & 3) + 1) >> 1) - 1;
}

// Digits j0 .. j0+N-1 (indices mod L, j0 >= -L) of shift_mod(x, s), x one
// row of L digits, s in [0, 2W) (64 bits: 2W = 32 L passes an int from L
// 2^26).  V == 4 (L % 4 == 0, x 16-byte aligned): the rotated
// sources of destinations j0-1 .. j0+N-1 are N+1 consecutive words mod L,
// read as (N+7)/4 aligned int4 chunks -- one window for all of a thread's
// runs, where mf::twist reads two chunks a run -- and picked by two select
// rounds; then the sub-digit shift (digit 0 takes digit L-1's high part
// negated) and the sign, twist's sequence.  V == 1: shift_mod_digit a digit.
template <int V, int N>
__device__ __forceinline__ void shifted_digits(const int* x, int j0, long long s, int L,
                                               int (&out)[N]) {
  if constexpr (V == 1) {
#pragma unroll
    for (int t = 0; t < N; ++t) out[t] = shift_mod_digit(x, ((j0 + t) % L + L) % L, s, L);
  } else {
    static_assert(V == 4, "runs of 1 or 4 digits");
    constexpr int C = (N + 7) / 4;
    const long long W = 16LL * L;
    const bool neg = s >= W;
    const long long r = neg ? s - W : s;
    const int kd = static_cast<int>(r >> 4), b = static_cast<int>(r & 15), sh = DIGIT_BITS - b;
    int e0 = j0 - 1;               // the destination of the window's first word
    if (e0 < 0) e0 += L;
    int s0 = e0 - kd;
    if (s0 < 0) s0 += L;
    const int o = s0 & 3;
    int w[4 * C];
    int c = s0 & ~3;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int4 a = *reinterpret_cast<const int4*>(x + c);
      w[4 * k] = a.x;
      w[4 * k + 1] = a.y;
      w[4 * k + 2] = a.z;
      w[4 * k + 3] = a.w;
      c = c + 4 == L ? 0 : c + 4;
    }
    int y[N + 3];
#pragma unroll
    for (int t = 0; t < N + 3; ++t) y[t] = (o & 1) ? w[t + 1] : w[t];
    int v[N + 1];
    int e = e0;
#pragma unroll
    for (int t = 0; t < N + 1; ++t) {   // destinations below kd wrapped: negated
      v[t] = (o & 2) ? y[t + 2] : y[t];
      if (e < kd) v[t] = -v[t];
      e = e + 1 == L ? 0 : e + 1;
    }
    const int lo = (1 << sh) - 1;
    e = e0 + 1 == L ? 0 : e0 + 1;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const int hi = v[t] >> sh;
      const int d = shl(v[t + 1] & lo, b) + (e == 0 ? -hi : hi);
      out[t] = neg ? -d : d;
      e = e + 1 == L ? 0 : e + 1;
    }
  }
}

// One carry pass over digits i0 .. i0+D-1 in place, given prev, the digit
// below i0 (digit L-1 at i0 == 0, whose carry wraps negated).
template <int D>
__device__ __forceinline__ void carry_digits(int (&v)[D], int prev, int i0) {
  int c = prev >> DIGIT_BITS;
  if (i0 == 0) c = -c;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int n = v[j] >> DIGIT_BITS;
    v[j] = (v[j] & DIGIT_MASK) + c;
    c = n;
  }
}

// Digits i0 .. i0+D-1 of shift_mod(x, s) after two carry passes (digits in
// [-1, 2^16]), 0 where i0 >= L: the thread recomputes the two shifted
// digits below its run (mod L: the row's top ones at i0 == 0), so the
// passes need no exchange; the first pass's digit i0-1 from the two below.
template <int V, int D>
__device__ __forceinline__ void carried_digits(const int* x, int i0, long long s, int L,
                                               int (&v)[D]) {
  int u2 = 0, u1 = 0;       // the shifted digits i0-2, i0-1 (mod L)
  if (i0 < L) {
    int w[D + 2];
    shifted_digits<V, D + 2>(x, i0 - 2, s, L, w);
    u2 = w[0];
    u1 = w[1];
#pragma unroll
    for (int j = 0; j < D; ++j) v[j] = w[j + 2];
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) v[j] = 0;
  }
  const int im1 = i0 == 0 ? L - 1 : i0 - 1;
  const int c1 = u2 >> DIGIT_BITS;
  const int p1 = (u1 & DIGIT_MASK) + (im1 == 0 ? -c1 : c1);
  carry_digits(v, u1, i0);
  carry_digits(v, p1, i0);
}

// The composed transition of the runs below L (the three carry chains of a
// run, then one code_then a run).
template <int V, int R>
__device__ __forceinline__ int runs_code(const int (&v)[V * R], int i0, int L) {
  int code = kCodeIdentity;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    int cm = -1, c0 = 0, cp = 1;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int d = v[V * r + u];
      cm = (d + cm) >> DIGIT_BITS;
      c0 = (d + c0) >> DIGIT_BITS;
      cp = (d + cp) >> DIGIT_BITS;
    }
    if (i0 + V * r < L) code = code_then(code_pack(cm, c0, cp), code);
  }
  return code;
}

// The transition of a thread's digits below L (digits in [-2^16+1,
// 2^17-2]), and in place their canonical form for a carry in of 0: f(0) is
// that chain's carry out c, f(1) = c + 1 where the canonical digits are all
// 0xFFFF, f(-1) = c - 1 where they are all 0 (one chain, not three).
template <int V, int R>
__device__ __forceinline__ int canon_code(int (&v)[V * R], int i0, int L) {
  int c = 0, ones = DIGIT_MASK, any = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (i0 + V * r < L) {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int t = v[V * r + u] + c;
        v[V * r + u] = t & DIGIT_MASK;
        c = t >> DIGIT_BITS;
        ones &= t;
        any |= t & DIGIT_MASK;
      }
    }
  }
  return code_pack(any == 0 ? c - 1 : c, c, (ones & DIGIT_MASK) == DIGIT_MASK ? c + 1 : c);
}

// Exact carries from cin: canonical digits in [0, 2^16).
template <int D>
__device__ __forceinline__ void apply_carries(int (&v)[D], int cin) {
  int c = cin;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int t = v[j] + c;
    v[j] = t & DIGIT_MASK;
    c = t >> DIGIT_BITS;
  }
}

// Whether a digit below L stops the ripple of r - cout: a digit other than
// 0xFFFF (cout == -1, a +1 ripples) or 0 (cout == +1, a -1 ripples).
template <int D>
__device__ __forceinline__ bool stops_ripple(const int (&r)[D], int i0, int L, int cout) {
  const int prop = cout < 0 ? DIGIT_MASK : 0;
  bool any = false;
#pragma unroll
  for (int j = 0; j < D; ++j) any |= i0 + j < L && r[j] != prop;
  return any;
}

// r - cout (mod p) on the canonical digits of thread (or lane) g of a row:
// first is the first thread whose digits stop the ripple, or -1 where none
// does (the result is the -1 form).  Threads below first take the ripple's
// fill, thread first ripples locally, the rest keep their digits.
template <int D>
__device__ __forceinline__ void fold_digits(int (&r)[D], int cout, int g, int first, int i0) {
  if (cout == 0 || g > first) {
    if (cout != 0 && first < 0) {
#pragma unroll
      for (int j = 0; j < D; ++j) r[j] = i0 + j == 0 ? -1 : 0;
    }
    return;
  }
  const int prop = cout < 0 ? DIGIT_MASK : 0;
  const int fill = cout < 0 ? 0 : DIGIT_MASK;
  bool on = true;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const bool stop = on && r[j] != prop;
    r[j] = stop ? r[j] - cout : (on ? fill : r[j]);
    on = on && !stop;
  }
}

template <int V, int R, bool CS = false>
__device__ __forceinline__ void store_runs(int* outr, int i0, int L, const int (&r)[V * R]) {
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (i0 + V * q < L) {
      int t[V];
#pragma unroll
      for (int u = 0; u < V; ++u) t[u] = r[V * q + u];
      store_run<V, CS>(outr + i0 + V * q, t);
    }
  }
}

// Short rows: lanes base .. base+G-1 of the warp hold one row, lane g the
// digits g*D .. g*D+D-1; live is false for a lane without a row (past the
// batch, or past the warp's whole groups), which still takes part in every
// shuffle.  Every lane of the warp calls it.
template <int V, int R>
__device__ __forceinline__ void normmod_short(const int* x, int* outr, int L, long long s, int G,
                                              int base, int g, bool live) {
  constexpr int D = V * R;
  const int i0 = g * D;
  int v[D];
  if (live) {
    shifted_digits<V, D>(x, i0, s, L, v);
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) v[j] = 0;
  }
  // two carry passes: the digit below the run from the lane below, digit
  // L-1 (lane gl, local jl) for lane 0
  const int gl = (L - 1) / D, jl = (L - 1) - gl * D;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    int wl = 0;
#pragma unroll
    for (int j = 0; j < D; ++j) wl = j == jl ? v[j] : wl;
    const int up = __shfl_up_sync(kFullMask, v[D - 1], 1);
    const int wrap = __shfl_sync(kFullMask, wl, base + gl);
    carry_digits(v, g == 0 ? wrap : up, i0);
  }
  // exact carries: inclusive scan of the lanes' transitions
  int code = runs_code<V, R>(v, i0, live ? L : 0);
  for (int off = 1; off < G; off <<= 1) {
    const int t = __shfl_up_sync(kFullMask, code, off);
    if (g >= off) code = code_then(code, t);
  }
  const int total = __shfl_sync(kFullMask, code, base + G - 1);
  int before = __shfl_up_sync(kFullMask, code, 1);
  if (g == 0) before = kCodeIdentity;
  apply_carries(v, code_carry0(before));
  const int cout = code_carry0(total);
  // the carry-out's ripple: the first lane of the row with a stopping digit
  const unsigned ballot =
      __ballot_sync(kFullMask, live && cout != 0 && stops_ripple(v, i0, L, cout));
  const unsigned mine = G == 32 ? ballot : (ballot >> base) & ((1u << G) - 1);
  fold_digits(v, cout, g, mine ? __ffs(static_cast<int>(mine)) - 1 : -1, i0);
  if (live) store_runs<V, R>(outr, i0, L, v);
}

// The exact carry of NR rows held by the CTA, thread t the digits i0 ..
// i0+D-1 of each (i0 = t*D; blockDim.x a multiple of 32, blockDim.x * D >=
// L), after one carry pass: digits in [-2^16+1, 2^17-2], where every
// digit's transition maps {-1,0,1} into itself (one carry pass of any int32
// row lands there).  A warp-shuffle scan of the transitions, then one scan
// of the <= 32 warp totals through shared memory (row q's on warp q mod the
// warp count), the carry-out's fold;
// writes the L canonical digits of row q to outr[q].  The rows share every
// barrier: two, a third only when a row's carry-out is not 0.  Every thread
// of the block calls it; it may be called again (a loop over rows) without
// a barrier between.
template <int V, int R, int NR, bool CS = false>
__device__ __forceinline__ void exact_rows(int (&v)[NR][V * R], int i0, int L,
                                           int* const (&outr)[NR]) {
  __shared__ int warp_code[NR][32], warp_before[NR][32], warp_first[NR][32], row_cout[NR];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = static_cast<int>(blockDim.x >> 5);
  const bool on = i0 < L;
  // exact carries: warp scan, then a scan of the warp totals
  int code[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) code[q] = canon_code<V, R>(v[q], i0, L);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const int c = __shfl_up_sync(kFullMask, code[q], off);
      if (lane >= off) code[q] = code_then(code[q], c);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int q = 0; q < NR; ++q) warp_code[q][warp] = code[q];
  }
  __syncthreads();
  for (int q = warp; q < NR; q += nwarps) {   // row q's warp totals on warp q (mod nwarps)
    int w = lane < nwarps ? warp_code[q][lane] : kCodeIdentity;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int c = __shfl_up_sync(kFullMask, w, off);
      if (lane >= off) w = code_then(w, c);
    }
    const int b = __shfl_up_sync(kFullMask, w, 1);
    warp_before[q][lane] = lane == 0 ? kCodeIdentity : b;
    if (lane == 31) row_cout[q] = code_carry0(w);
  }
  __syncthreads();
  int cout[NR], first[NR];
  bool any = false;
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    int before = __shfl_up_sync(kFullMask, code[q], 1);
    if (lane == 0) before = kCodeIdentity;
    apply_carries(v[q], code_carry0(code_then(before, warp_before[q][warp])));
    cout[q] = row_cout[q];
    first[q] = -1;
    any |= cout[q] != 0;
  }
  if (any) {                // the same for every thread of the block
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      const unsigned ballot =
          __ballot_sync(kFullMask, on && cout[q] != 0 && stops_ripple(v[q], i0, L, cout[q]));
      if (lane == 0)
        warp_first[q][warp] = ballot ? warp * 32 + __ffs(static_cast<int>(ballot)) - 1 : -1;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < NR; ++q)
      for (int w = nwarps - 1; w >= 0; --w) first[q] = warp_first[q][w] >= 0 ? warp_first[q][w] : first[q];
  }
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    fold_digits(v[q], cout[q], t, first[q], i0);
    if (on) store_runs<V, R, CS>(outr[q], i0, L, v[q]);
  }
}

// Block rows: the CTA holds the row x (global or shared memory; read only
// before the first barrier), thread t the digits t*D .. t*D+D-1 (blockDim.x
// a multiple of 32, blockDim.x * D >= L), and writes the L canonical digits
// to outr.  Every thread of the block calls it; the caller may overwrite x
// once it returns.
template <int V, int R>
__device__ __forceinline__ void normmod_row(const int* x, int L, long long s, int* outr) {
  constexpr int D = V * R;
  const int i0 = threadIdx.x * D;
  int v[1][D];
  carried_digits<V, D>(x, i0, s, L, v[0]);
  int* const o[1] = {outr};
  exact_rows<V, R, 1>(v, i0, L, o);
}

// The layout of a row, one rule for every caller.  V: runs of 4 digits
// where L % 4 == 0 and both the input and the output rows are 16-byte
// aligned, else of 1.
inline int run_width(int L, const void* x, const void* out) {
  return L % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0 &&
                 reinterpret_cast<size_t>(out) % 16 == 0
             ? 4
             : 1;
}

// Block rows: kBlockDigits digits a thread (normmod_row<4, 2> or <1, 8>),
// in as many whole warps as the row needs -- up to 1024 threads, so rows up
// to 8192 digits.
constexpr int kBlockDigits = 8;
inline int block_row_threads(int L) { return ((L + kBlockDigits - 1) / kBlockDigits + 31) / 32 * 32; }

}  // namespace mf
