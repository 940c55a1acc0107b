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
//   * A sub-transform (FFT / IFFT) is csrc/cluster_rows.cuh's run_transform,
//     the routine the whole-row transform's wide rows run
//     (csrc/transform_small.cu): the stages of csrc/ladder_group.cuh's group
//     routine in ladder_groups' stage ranges with the in-place carry between
//     them, the column's cross exponents in the group's pe form at the
//     forward's last stage and the inverse's first, and the stages whose
//     pairs span two CTAs row by row through distributed shared memory.
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
#include "cluster_rows.cuh"

namespace {

using mf::carry_of;
using mf::neg_exp;
using mf::red;
using mf::Rows;
using mf::row_pass;
using mf::shift_of;

constexpr int kOpFields = 8;
// threads a CTA: 128 registers each hold one CTA an SM
constexpr int kThreads = 512;

enum OpKind {
  OP_FFT = 0, OP_IFFT, OP_TOP_FWD, OP_FOLD, OP_DOUBLE, OP_RESTORE, OP_PE_DIV,
  OP_TAIL0, OP_TAIL1, OP_BFLY_INV, OP_OUT1
};

template <int V, class G>
__device__ __forceinline__ void digits(int (&o)[V], int i0, G g) {
#pragma unroll
  for (int t = 0; t < V; ++t) o[t] = g(i0 + t);
}

// An op whose outputs are rows [r0, r1), each from its own row and rows
// that the op does not write: this CTA's share, CTA-local rounds.
template <int V, int P, int T, class F>
__device__ void single_op(const Rows& c, int r0, int r1, F f) {
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
__device__ void pair_op(const Rows& c, int lo, int n, int ja, int jb, F f) {
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

template <int V, int P, int T>
__device__ void run_op(const Rows& c, const long long* op, int kmax) {
  const int L = c.L;
  const long long W2 = c.W2;
  const int kind = static_cast<int>(op[0]), lo = static_cast<int>(op[1]);
  const int n = static_cast<int>(op[2]), k = static_cast<int>(op[3]);
  const long long e1 = op[4], e2 = op[5], w = op[6];
  const bool use_pe = op[7] != 0;
  switch (kind) {
    case OP_FFT:
    case OP_IFFT:
      if (n > 1) {
        mf::run_transform<V, P, T>(c, lo, n, w, kind == OP_IFFT, use_pe, kmax);
      } else if (use_pe) {    // length 1: the table's shift alone
        single_op<V, P, T>(c, lo, lo + 1, [&](int q, int i0, int (&o)[V]) {
          mf::twist<V, 0>(c.row(q), nullptr, i0,
                          kind == OP_IFFT ? neg_exp(c.pe[q], W2) : c.pe[q], L, o);
          return true;
        });
      }
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
// ladder tables, ints.
size_t cols_smem_ints(int n2, int rpc, int L) {
  return static_cast<size_t>(rpc) * L + n2 + (n2 > 2 ? n2 / 2 : 1) + 2 * mf::rows_tab_ints(rpc);
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
  int* tab1 = tab0 + mf::rows_tab_ints(rpc);
  const long long W2 = 32LL * L;
  const Rows c{buf, x + base, pe, ew, tab0, tab1, W2, L, rpc, lg_rpc, rank, R};

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
  const size_t smem = sizeof(int) * cols_smem_ints(n2, n2 / R, L);
  return static_cast<int>(mf::launch_rows(
      mfa_cols_kernel<V, P>, B, R, kThreads, smem, stream, static_cast<const int*>(x),
      static_cast<int*>(out), static_cast<const long long*>(sched), nops, n2, L, n1_mask, j1_off,
      wx, kmax, R));
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
      nops < 0 || R < 1 || R > mf::kMaxCluster || (R & (R - 1)) || n2 % R ||
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
