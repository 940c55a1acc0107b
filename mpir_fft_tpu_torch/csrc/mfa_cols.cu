// The column pass of a 2-D MFA transform: every (n2, L) column transformed
// whole -- full or truncated, forward or inverse -- with its cross twiddles,
// the column resident in the shared memory of one CTA or of a thread-block
// cluster of R = 2, 4 or 8 CTAs.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_batched_idx (fused.py:200,
// pallas_call :232) as ops/mfa.py _run_cols uses it (mfa.py:104-142): the
// block's column transforms fcol with the cross exponents of
// _block_cross_exps (mfa.py:64-74), for every column the reference fuses
// (L <= 1024; truncated, or full with a padded block of at most 512 KB).
// Plain version: ops/fused.py mfa_cols_plain (the truncated transforms of
// ops/truncate.py with the same table), whose integer sequence this kernel
// repeats, so the digits agree.
//
// x, out: (B, n2, L) int32, leading axes flattened into B; flat row b is
// column j1 = j1_off + (b & n1_mask) (masked per row, so a batch spanning
// several copies of the column axis -- the stacked operands, the doubled n2
// of even w -- wraps right: the reference's round-1 bug,
// tests/test_mfa.py:173; j1_off is the first column of a block of the
// columns, a rank's share under sharding, mfa.py:64-74's `off`).
// Row j2 of column j1 carries the cross exponent pe(j2) = w revbin(j2) j1
// mod 2W, the z^(k2 j1) twiddle: multiplied in at the forward's last stage,
// divided out before the inverse's first.
//
// The truncation recursion depends only on (n2, trunc2, flavour), all known
// on the host, so ops/fused.py mfa_cols_schedule builds it there as a list
// of in-place row ops (Op below; its docstring defines each) and this
// kernel interprets the list.
//
// What bounds it on an H100: device memory -- one read and one write of
// each column per launch -- against ~log2(n2) in-place stages of
// shared-memory traffic and integer issue per digit.  Design:
//   * The column lives in ONE in-place buffer; a cluster of R CTAs holds
//     n2 / R contiguous rows each (R from the column's bytes: the wrapper,
//     ops/fused.py mfa_col_cluster).  Nothing else: no scratch rows.
//   * A sub-transform (FFT / IFFT) runs as the whole-row transform runs its
//     row (csrc/transform_small.cu): the stages of csrc/ladder_group.cuh's
//     group routine, ladder_groups' stage ranges with the in-place carry
//     between them, twiddles tabled once per (stage, pair) from the C/2
//     exponents u w mod 2W, the column's cross exponents in the group's pe
//     form at the forward's last stage and the inverse's first.  A stage
//     whose pairs span two CTAs (m rows apart >= the rows of a CTA) runs
//     row by row: each CTA computes its own rows' new digits, reading the
//     partner row through distributed shared memory, a cluster barrier
//     between the reads and the writes.
//   * The glue ops (top layers, folds, reconstructions, cross butterflies)
//     run the same way: each thread reads the windows its outputs need into
//     registers (the carry's lower neighbour is one more read of the same
//     row), the CTA -- or, where a pair spans two CTAs, the cluster --
//     syncs, and each thread writes its own row's digits in place.  Rounds
//     hold whole row pairs, so no row is written before its partner's
//     reads.
//   * The column loads by cp.async and stores as 16-byte vectors; each CTA
//     moves only its own rows.
// The deferred-carry growth ~2^(18+k) over a group of k <= 4 stages
// (fused.py:472-476) stays inside int32, as in the ladder.
#include <cooperative_groups.h>

#include "ladder_group.cuh"

namespace cg = cooperative_groups;

namespace {

using mf::carry_of;
using mf::shift_of;

constexpr int kOpFields = 8;
constexpr int kMaxCluster = 8;
// threads a CTA: 128 registers each hold one CTA an SM
constexpr int kThreads = 512;

enum OpKind {
  OP_FFT = 0, OP_IFFT, OP_TOP_FWD, OP_FOLD, OP_DOUBLE, OP_RESTORE, OP_PE_DIV,
  OP_TAIL0, OP_TAIL1, OP_BFLY_INV, OP_OUT1
};

// One CTA's view of its column: its own rows [rank * rpc, (rank+1) * rpc)
// in buf, the rest of the cluster's through row().
struct Col {
  int* buf;            // this CTA's rows, rpc rows of L digits
  const int* in;       // the column's input rows (global)
  const int* pe;       // the n2 cross exponents (shared)
  int* ew;             // the current sub-transform's exponents u*w mod 2W
  int* tab0;           // its ladder tables, this CTA's frame
  int* tab1;
  long long W2;        // 2W
  int L, rpc, lg_rpc, rank, R;

  // row q of the column, in this CTA or another of the cluster
  __device__ __forceinline__ const int* row(int q) const {
    const int rk = q >> lg_rpc;
    int* p = buf + (q - (rk << lg_rpc)) * L;
    return rk == rank ? p : cg::this_cluster().map_shared_rank(p, rk);
  }
  // every thread of the column's CTAs
  __device__ __forceinline__ void sync_all() const {
    if (R > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
};

__device__ __forceinline__ int red(long long e, long long W2) {
  e %= W2;
  return static_cast<int>(e < 0 ? e + W2 : e);
}

__device__ __forceinline__ int neg_exp(int e, long long W2) {   // 2W - e mod 2W
  return e ? static_cast<int>(W2) - e : 0;
}

template <int V, class G>
__device__ __forceinline__ void digits(int (&o)[V], int i0, G g) {
#pragma unroll
  for (int t = 0; t < V; ++t) o[t] = g(i0 + t);
}

// One pass over rows of this CTA in rounds of whole rows: slot s of a
// round's T*P items is run s % (L/V) of row slot s / (L/V); map(slot) is
// the local row, f(local row, i0, o) its new digits i0..i0+V-1 (false: the
// row is not an output).  Reads go to registers, then CROSS ? the cluster :
// the CTA syncs, then the writes.  Local passes round the rows per round
// down to whole pairs (map puts a pair's rows in consecutive slots).
// nrows: this CTA's slots; span: the slots that set the rounds (the same on
// every CTA of a CROSS pass, which every CTA of the cluster calls).  No
// barrier after the last round's writes.
template <int V, int P, int T, bool CROSS, class Map, class F>
__device__ __forceinline__ void row_pass(const Col& c, int nrows, int span, Map map, F f) {
  const int ipp = c.L / V;
  const int lg_ipp = mf::div_lg(ipp);
  const unsigned mg_ipp = mf::div_magic(ipp);
  int G = T * P / ipp;
  if (!CROSS && G > 1) G &= ~1;
  const int rounds = (span + G - 1) / G;
  for (int r = 0; r < rounds; ++r) {
    int o[P][V], at[P];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int s = u * T + static_cast<int>(threadIdx.x);
      const int sl = mf::div_small(s, lg_ipp, mg_ipp);
      const int slot = r * G + sl;
      at[u] = -1;
      if (sl < G && slot < nrows) {
        const int i0 = (s - sl * ipp) * V;
        const int ql = map(slot);
        if (f(ql, i0, o[u])) at[u] = ql * c.L + i0;
      }
    }
    if constexpr (CROSS)
      cg::this_cluster().sync();
    else
      __syncthreads();
#pragma unroll
    for (int u = 0; u < P; ++u)
      if (at[u] >= 0) mf::store_run<V>(c.buf + at[u], o[u]);
  }
}

// An op whose outputs are rows [r0, r1), each from its own row and rows
// that the op does not write: this CTA's share, CTA-local rounds.
template <int V, int P, int T, class F>
__device__ void single_op(const Col& c, int r0, int r1, F f) {
  const int first = c.rank * c.rpc;
  const int a = max(r0, first), b = min(r1, first + c.rpc);
  if (a >= b) return;
  row_pass<V, P, T, false>(c, b - a, b - a, [=](int s) { return a - first + s; },
                           [&](int ql, int i0, int (&o)[V]) { return f(first + ql, i0, o); });
}

// An op on the row pairs (lo + j, lo + n + j), j in [ja, jb), lo a multiple
// of 2n: f(side, j, A, B, i0, o) the new digits of the pair's row on `side`
// (0: row lo + j, 1: row lo + n + j; false: not an output).  Pairs inside a
// CTA (2n <= rpc) run there in local rounds of whole pairs; wider pairs
// span two CTAs, each computing its own rows (every CTA takes part).
template <int V, int P, int T, class F>
__device__ void pair_op(const Col& c, int lo, int n, int ja, int jb, F f) {
  if (ja >= jb) return;
  const int first = c.rank * c.rpc;
  auto fn = [&](int ql, int i0, int (&o)[V]) {
    const int rel = first + ql - lo, side = rel >= n ? 1 : 0, j = rel - side * n;
    if (j < ja || j >= jb) return false;
    return f(side, j, c.row(lo + j), c.row(lo + n + j), i0, o);
  };
  if (n >= c.rpc) {
    const bool mine = first >= lo && first < lo + 2 * n;
    row_pass<V, P, T, true>(c, mine ? c.rpc : 0, c.rpc, [](int s) { return s; }, fn);
  } else if ((lo >> c.lg_rpc) == c.rank) {
    const int off = lo - first;
    row_pass<V, P, T, false>(c, 2 * (jb - ja), 2 * (jb - ja),
                             [=](int s) { return off + ja + (s >> 1) + (s & 1) * n; }, fn);
  }
}

// Stage j of the sub-transform [lo, lo+C) whose pairs (m = C >> (j+1) rows
// apart, m >= rpc) span two CTAs: each CTA's rows are all on one side.
// Every CTA of the cluster calls it; it ends with the CTA in step.
template <int V, int P, int T>
__device__ void cross_stage(const Col& c, int lo, int C, int j, bool inverse) {
  const int m = C >> (j + 1);
  const int first = c.rank * c.rpc;
  const bool mine = first >= lo && first < lo + C;
  c.sync_all();                              // the partners' last writes
  row_pass<V, P, T, true>(
      c, mine ? c.rpc : 0, c.rpc, [](int s) { return s; },
      [&](int ql, int i0, int (&o)[V]) {
        const int q = first + ql, rel = q - lo;
        const bool b_side = rel & m;
        const int qa = b_side ? q - m : q;
        const int* A = c.row(qa);
        const int* B = c.row(qa + m);
        const int e = c.ew[(rel & (m - 1)) << j];
        if (!inverse) {
          if (b_side) {
            mf::twist<V, -1>(A, B, i0, e, c.L, o);
          } else {
            int a[V], b[V];
            mf::load_run<V>(A + i0, a);
            mf::load_run<V>(B + i0, b);
#pragma unroll
            for (int t = 0; t < V; ++t) o[t] = a[t] + b[t];
          }
        } else {
          int a[V], u[V];
          mf::twist<V, 0>(B, nullptr, i0, neg_exp(e, c.W2), c.L, u);
          mf::load_run<V>(A + i0, a);
#pragma unroll
          for (int t = 0; t < V; ++t) o[t] = b_side ? a[t] - u[t] : a[t] + u[t];
        }
        return true;
      });
  __syncthreads();
}

// A whole sub-transform of rows [lo, lo+C) at root w: the ladder groups of
// ops/fused.py ladder_groups (forward from stage 0 up, inverse from the top
// group down), each group's stages then its carry; the table at its last /
// first stage where use_pe.  This CTA's part: all of it where C <= rpc
// (only lo's CTA works), else its own rows, the stages whose pairs cross
// CTAs (j < xs) by cross_stage, the rest on the group routine.
template <int V, int P, int T>
__device__ void run_transform(const Col& c, int lo, int C, long long w, bool inverse,
                              bool use_pe, int kmax) {
  const int L = c.L;
  int D = 0;
  while ((1 << D) < C) ++D;
  if (D == 0) {        // length 1: the table's shift alone
    if (use_pe)
      single_op<V, P, T>(c, lo, lo + 1, [&](int q, int i0, int (&o)[V]) {
        mf::twist<V, 0>(c.row(q), nullptr, i0, inverse ? neg_exp(c.pe[q], c.W2) : c.pe[q], L, o);
        return true;
      });
    return;
  }
  const int Kl = min(C, c.rpc);
  int kl = 0;
  while ((1 << kl) < Kl) ++kl;
  const int xs = D - kl;                       // stages whose pairs cross CTAs
  const int first = c.rank * c.rpc;
  const int base = C <= c.rpc ? lo : first;    // this CTA's first row of the transform
  const bool active = (base >> c.lg_rpc) == c.rank && base >= lo && base < lo + C;
  const int half = C >> 1, halfl = Kl >> 1;
  if (active) {
    w %= c.W2;
    for (int u = threadIdx.x; u < half; u += T) c.ew[u] = static_cast<int>(u * w % c.W2);
  }
  __syncthreads();
  if (active) {
    // local stage jl is stage jl + xs; local pair pl the pair pl + (base - lo)/2
    const int poff = (base - lo) >> 1;
    for (int t = threadIdx.x; t < kl * halfl; t += T) {
      const int jl = t / halfl, pl = t - jl * halfl, j = jl + xs;
      const int m = C >> (j + 1), p = pl + poff;
      int s0 = 0, s1 = c.ew[(p & (m - 1)) << j];
      if (use_pe && m == 1) {
        s0 = c.pe[lo + 2 * p];
        s1 = c.pe[lo + 2 * p + 1];
      }
      c.tab0[t] = inverse ? neg_exp(s0, c.W2) : s0;
      c.tab1[t] = inverse ? neg_exp(s1, c.W2) : s1;
    }
  }
  __syncthreads();
  int* lbuf = c.buf + (base - first) * L;
  for (int done = 0; done < D;) {
    const int kg = min(kmax, D - done);
    const int j0 = inverse ? D - done - kg : done;
    const int l0 = max(j0, xs), x1 = min(j0 + kg, xs);
    if (!inverse)
      for (int j = j0; j < x1; ++j) cross_stage<V, P, T>(c, lo, C, j, false);
    if (active && l0 < j0 + kg)
      mf::ladder_group<V, P, T>(lbuf, Kl, kl, L, inverse, c.tab0, c.tab1, use_pe, l0 - xs,
                                j0 + kg - l0);
    if (inverse)
      for (int j = x1 - 1; j >= j0; --j) cross_stage<V, P, T>(c, lo, C, j, true);
    if (active) mf::carry_rows<V, P, T>(lbuf, Kl, L);
    done += kg;
  }
}

template <int V, int P, int T>
__device__ void run_op(const Col& c, const long long* op, int kmax) {
  const int L = c.L;
  const long long W2 = c.W2;
  const int kind = static_cast<int>(op[0]), lo = static_cast<int>(op[1]);
  const int n = static_cast<int>(op[2]), k = static_cast<int>(op[3]);
  const long long e1 = op[4], e2 = op[5], w = op[6];
  const bool use_pe = op[7] != 0;
  switch (kind) {
    case OP_FFT:
    case OP_IFFT:
      run_transform<V, P, T>(c, lo, n, w, kind == OP_IFFT, use_pe, kmax);
      break;
    case OP_TOP_FWD:    // j < n: s = carry(a+b) (j < k), t = (a-b) z^j or a z^j
      pair_op<V, P, T>(c, lo, n, 0, n,
                       [&](int side, int j, const int* A, const int* B, int i0, int (&o)[V]) {
        if (side == 0) {
          if (j >= k) return false;
          digits(o, i0, [&](int i) { return carry_of([&](int x) { return A[x] + B[x]; }, i, L); });
        } else if (j < k) {
          mf::twist<V, -1>(A, B, i0, red(j * w, W2), L, o);
        } else {
          mf::twist<V, 0>(A, nullptr, i0, red(j * w, W2), L, o);
        }
        return true;
      });
      break;
    case OP_FOLD:       // j in [k, e1): x_j = carry(x_j + x_{j+n})
      single_op<V, P, T>(c, lo + k, lo + static_cast<int>(e1), [&](int q, int i0, int (&o)[V]) {
        const int* A = c.row(q);
        const int* B = c.row(q + n);
        digits(o, i0, [&](int i) { return carry_of([&](int x) { return A[x] + B[x]; }, i, L); });
        return true;
      });
      break;
    case OP_DOUBLE:     // j < n: x_j = carry(2 x_j)
      single_op<V, P, T>(c, lo, lo + n, [&](int q, int i0, int (&o)[V]) {
        const int* A = c.row(q);
        digits(o, i0, [&](int i) { return carry_of([&](int x) { return A[x] + A[x]; }, i, L); });
        return true;
      });
      break;
    case OP_RESTORE:    // j < n: x_j = the kernel's input row
      single_op<V, P, T>(c, lo, lo + n, [&](int q, int i0, int (&o)[V]) {
        mf::load_run<V>(c.in + static_cast<long long>(q) * L + i0, o);
        return true;
      });
      break;
    case OP_PE_DIV:     // j < n: x_j / 2^pe(lo+j)
      single_op<V, P, T>(c, lo, lo + n, [&](int q, int i0, int (&o)[V]) {
        mf::twist<V, 0>(c.row(q), nullptr, i0, neg_exp(c.pe[q], W2), L, o);
        return true;
      });
      break;
    case OP_TAIL0:      // j in [k, n): t_j = s_j z^j / 2^lgh into row n+j; s_j = carry(2 s_j)
      pair_op<V, P, T>(c, lo, n, k, n,
                       [&](int side, int j, const int* A, const int*, int i0, int (&o)[V]) {
        if (side == 0)
          digits(o, i0, [&](int i) { return carry_of([&](int x) { return A[x] + A[x]; }, i, L); });
        else
          mf::twist<V, 0>(A, nullptr, i0, red(j * w - e1, W2), L, o);
        return true;
      });
      break;
    case OP_TAIL1:      // j in [k, n), s = row j, v = row n+j:
      // t_j = (carry(s / 2^lgh - carry(2v))) z^j into row n+j,
      // row j = carry(carry(2s) - v 2^lgC)
      pair_op<V, P, T>(c, lo, n, k, n,
                       [&](int side, int j, const int* A, const int* B, int i0, int (&o)[V]) {
        if (side == 0) {
          const int sb = red(e2, W2);
          auto z = [&](int x) {
            return carry_of([&](int y) { return A[y] + A[y]; }, x, L) -
                   shift_of([&](int y) { return B[y]; }, x, sb, L);
          };
          digits(o, i0, [&](int i) { return carry_of(z, i, L); });
        } else {
          const int sa = red(-e1, W2), sj = red(j * w, W2);
          auto y = [&](int x) {
            return shift_of([&](int v) { return A[v]; }, x, sa, L) -
                   carry_of([&](int v) { return B[v] + B[v]; }, x, L);
          };
          digits(o, i0, [&](int i) {
            return shift_of([&](int x) { return carry_of(y, x, L); }, i, sj, L);
          });
        }
        return true;
      });
      break;
    case OP_BFLY_INV:   // j < k: u = t_j / z^j; carry(s_j + u), carry(s_j - u)
      pair_op<V, P, T>(c, lo, n, 0, k,
                       [&](int side, int j, const int* A, const int* B, int i0, int (&o)[V]) {
        const int s = neg_exp(red(j * w, W2), W2);
        const int sg = side ? -1 : 1;
        auto v = [&](int x) { return A[x] + sg * shift_of([&](int y) { return B[y]; }, x, s, L); };
        digits(o, i0, [&](int i) { return carry_of(v, i, L); });
        return true;
      });
      break;
    case OP_OUT1:       // j < k: x_j = carry(carry(2 x_j) - x_{j+n} 2^lgC)
      single_op<V, P, T>(c, lo, lo + k, [&](int q, int i0, int (&o)[V]) {
        const int* A = c.row(q);
        const int* B = c.row(q + n);
        const int sb = red(e2, W2);
        auto z = [&](int x) {
          return carry_of([&](int y) { return A[y] + A[y]; }, x, L) -
                 shift_of([&](int y) { return B[y]; }, x, sb, L);
        };
        digits(o, i0, [&](int i) { return carry_of(z, i, L); });
        return true;
      });
      break;
    default:
      break;
  }
  c.sync_all();
}

// The rows buffer, the n2 cross exponents, n2/2 exponents u*w and the two
// ladder tables (log2(rpc) stages of rpc/2 pairs), ints.
__host__ __device__ inline int tab_ints(int rpc) {
  int lg = 0;
  while ((1 << lg) < rpc) ++lg;
  return (lg > 1 ? lg : 1) * (rpc > 2 ? rpc / 2 : 1);
}

size_t cols_smem_ints(int n2, int rpc, int L) {
  return static_cast<size_t>(rpc) * L + n2 + (n2 > 2 ? n2 / 2 : 1) + 2 * tab_ints(rpc);
}

template <int V, int P, int T = kThreads>
__global__ void __launch_bounds__(T, 1)
mfa_cols_kernel(const int* __restrict__ x, int* __restrict__ out,
                const long long* __restrict__ sched, int nops, int n2, int L, long long n1_mask,
                long long j1_off, long long wx, int kmax, int R) {
  extern __shared__ int4 smem4[];
  const int rpc = n2 / R;
  int lg_rpc = 0;
  while ((1 << lg_rpc) < rpc) ++lg_rpc;
  int lgn2 = 0;
  while ((1 << lgn2) < n2) ++lgn2;
  const long long b = blockIdx.x / R;
  const int rank = static_cast<int>(blockIdx.x % R);
  const long long base = b * n2 * static_cast<long long>(L);
  int* buf = reinterpret_cast<int*>(smem4);
  int* pe = buf + rpc * L;
  int* ew = pe + n2;
  int* tab0 = ew + (n2 > 2 ? n2 / 2 : 1);
  int* tab1 = tab0 + tab_ints(rpc);
  const long long W2 = 32LL * L;
  const Col c{buf, x + base, pe, ew, tab0, tab1, W2, L, rpc, lg_rpc, rank, R};

  // this CTA's rows, and the column's cross exponents
  const int* src = x + base + static_cast<long long>(rank) * rpc * L;
  const int cnt = rpc * L / V;
  for (int idx = threadIdx.x; idx < cnt; idx += T) {
    if constexpr (V == 4) {
      mf::cp_async16(buf + 4 * idx, src + 4 * idx);
    } else {
      buf[idx] = src[idx];
    }
  }
  const long long j1 = j1_off + (b & n1_mask);
  wx %= W2;
  for (int q = threadIdx.x; q < n2; q += T) {
    const long long r = lgn2 ? __brev(static_cast<unsigned>(q)) >> (32 - lgn2) : 0;
    pe[q] = static_cast<int>(wx * r % W2 * j1 % W2);
  }
  if constexpr (V == 4) mf::cp_async_wait_all();
  c.sync_all();
  for (int o = 0; o < nops; ++o) run_op<V, P, T>(c, sched + o * kOpFields, kmax);
  int* dst = out + base + static_cast<long long>(rank) * rpc * L;
  for (int idx = threadIdx.x; idx < cnt; idx += T) {
    int v[V];
    mf::load_run<V>(buf + V * idx, v);
    mf::store_run<V>(dst + V * idx, v);
  }
}

template <int V, int P>
int launch(const void* x, void* out, const void* sched, int nops, long long B, int n2, int L,
           long long n1_mask, long long j1_off, long long wx, int kmax, int R, void* stream) {
  const auto kernel = mfa_cols_kernel<V, P>;
  const size_t smem = sizeof(int) * cols_smem_ints(n2, n2 / R, L);
  cudaError_t err = mf::prepare_group_kernel(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * R));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(R);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = R > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const int*>(x), static_cast<int*>(out),
                           static_cast<const long long*>(sched), nops, n2, L, n1_mask, j1_off, wx,
                           kmax, R);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (B, n2, L) int32; sched: device int64 [nops, 8] (ops/fused.py
// mfa_cols_schedule); n1_mask = the block's column count - 1 (n1 - 1 for
// all n1 columns); j1_off: the block's first column (0 for all of them);
// wx: the cross-twiddle exponent w;
// kmax: stages per carry group; R: the column's CTAs, a cluster where R > 1
// (1, 2, 4 or 8, n2 / R >= 2 rows each), the wrapper's choice
// (ops/fused.py mfa_col_cluster, which keeps each CTA's block within the
// card's shared memory; a block the card cannot hold fails with CUDA's own
// error).  Runs of 4 digits where L % 4 == 0
// and x, out are 16-byte aligned, else of one.
MF_EXPORT int mf_mfa_cols(const void* x, void* out, const void* sched, int nops, long long B,
                          int n2, int L, long long n1_mask, long long j1_off, long long wx,
                          int kmax, int R, void* stream) {
  if (n2 < 1 || (n2 & (n2 - 1)) || L < 1 || kmax < 1 || kmax > mf::kMaxLadderStages ||
      nops < 0 || R < 1 || R > kMaxCluster || (R & (R - 1)) || n2 % R ||
      (R > 1 && n2 / R < 2) || j1_off < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B * R > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec = L % 4 == 0 &&
                   (reinterpret_cast<unsigned long long>(x) |
                    reinterpret_cast<unsigned long long>(out)) % 16 == 0;
  if (vec) return launch<4, 4>(x, out, sched, nops, B, n2, L, n1_mask, j1_off, wx, kmax, R, stream);
  return launch<1, 8>(x, out, sched, nops, B, n2, L, n1_mask, j1_off, wx, kmax, R, stream);
}
