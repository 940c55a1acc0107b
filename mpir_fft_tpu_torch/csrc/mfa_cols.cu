// The column pass of a 2-D MFA transform: every (n2, L) column transformed
// whole -- full or truncated, forward or inverse -- with its cross twiddles,
// the column resident in shared memory.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_batched_idx (fused.py:200,
// pallas_call :232) as ops/mfa.py _run_cols uses it (mfa.py:104-142): the
// block's column transforms fcol with the cross exponents of
// _block_cross_exps (mfa.py:64-74).  Plain version: ops/fused.py
// mfa_cols_plain (the truncated transforms of ops/truncate.py with the same
// table), whose integer sequence this kernel repeats, so the digits agree.
//
// x, out: (B, n2, L) int32, leading axes flattened into B; flat row b is
// column j1 = b & n1_mask (masked per row, so a batch spanning several
// copies of the column axis -- the stacked operands, the doubled n2 of even
// w -- wraps right: the reference's round-1 bug, tests/test_mfa.py:173).
// Row j2 of column j1 carries the cross exponent pe(j2) = w revbin(j2) j1
// mod 2W, the z^(k2 j1) twiddle: multiplied in at the forward's last stage,
// divided out before the inverse's first.
//
// The truncation recursion depends only on (n2, trunc2, flavour), all known
// on the host, so ops/fused.py mfa_cols_schedule builds it there as a list
// of in-place row ops (Op below; its docstring defines each) and this
// kernel interprets the list: sub-transforms as ladder stage groups with a
// carry after each group (the groups of ladder_groups, kmax stages), and
// the glue -- top layers, folds, reconstructions, cross butterflies -- as
// row-pair ops with the carries where the plain version carries.
//
// What bounds it on an H100: device memory -- one read and one write of
// each column per launch; the O(log n2) sweeps run on shared memory.
// Design: one CTA per column; the (n2, L) column (128 KB at (128, 256))
// leaves no room for the ping-pong pair transform_small keeps, so every op
// works in place: each warp takes one row pair (or row) at a time, builds
// its outputs in three scratch rows of its own, and writes them back (with
// the carry where the op carries).  Pairs of one op are disjoint, so warps
// need no barrier within an op; the CTA syncs between ops and stages.  The
// deferred-carry growth ~2^(18+k) over a group of k <= 4 stages
// (fused.py:472-476) stays inside int32, as in the ladder.
#include "common.cuh"

namespace {

constexpr int kOpFields = 8;

enum OpKind {
  OP_FFT = 0, OP_IFFT, OP_TOP_FWD, OP_FOLD, OP_DOUBLE, OP_RESTORE, OP_PE_DIV,
  OP_TAIL0, OP_TAIL1, OP_BFLY_INV, OP_OUT1
};

struct Col {
  int* X;              // the column, n2 rows of L digits
  const int* in;       // the column's input rows (global)
  int L;
  long long W2;        // 2W
  long long wx;        // cross-twiddle root exponent w
  long long j1;        // the column index
  int lgn2;
  int warps;           // the CTA's warps, each with three scratch rows
};

__device__ __forceinline__ long long pe_of(const Col& c, int row) {
  int r = 0;
  for (int b = 0; b < c.lgn2; ++b) r |= ((row >> b) & 1) << (c.lgn2 - 1 - b);
  return (c.wx * r % c.W2) * c.j1 % c.W2;
}

__device__ __forceinline__ long long red(long long e, long long W2) {
  e %= W2;
  return e < 0 ? e + W2 : e;
}

// One stage of a length-C sub-transform at rows [lo, lo+C): stage s pairs
// (qa, qa + half), half = C >> (s+1), twiddle (pos * (w << s)) mod 2W.  The
// forward's last stage takes the table (s = (a+b) 2^pe(qa), t = (a-b)
// 2^(e + pe(qb))), the inverse's first divides it out.  carry: the last
// stage of a group (the write-back carries each row).
__device__ void stage(const Col& c, int* S, int lo, int C, int s, long long w, bool inverse,
                      bool use_pe, bool carry) {
  const int L = c.L, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = C >> (s + 1);
  const long long step = w << s;
  int* S0 = S;
  int* S1 = S + L;
  for (int p = warp; p < C / 2; p += c.warps) {
    const int pos = p % half;
    const int qa = lo + (p / half) * 2 * half + pos, qb = qa + half;
    const long long e = (pos * step) % c.W2;
    const int* A = c.X + qa * L;
    const int* B = c.X + qb * L;
    if (use_pe) {     // half == 1: e == 0
      const long long e0 = pe_of(c, qa), e1 = (e + pe_of(c, qb)) % c.W2;
      for (int i = lane; i < L; i += 32) {
        if (!inverse) {
          S0[i] = mf::shift_comb_digit(A, B, 1, i, e0, L);
          S1[i] = mf::shift_comb_digit(A, B, -1, i, e1, L);
        } else {
          const int a = mf::shift_mod_digit(A, i, (c.W2 - e0) % c.W2, L);
          const int u = mf::shift_mod_digit(B, i, (c.W2 - e1) % c.W2, L);
          S0[i] = a + u;
          S1[i] = a - u;
        }
      }
    } else {
      for (int i = lane; i < L; i += 32)
        mf::butterfly_digit(A, B, i, L, e, inverse, S0 + i, S1 + i);
    }
    __syncwarp();
    for (int i = lane; i < L; i += 32) {
      c.X[qa * L + i] = carry ? mf::carry_digit(S0, i, L) : S0[i];
      c.X[qb * L + i] = carry ? mf::carry_digit(S1, i, L) : S1[i];
    }
    __syncwarp();
  }
}

// A whole sub-transform of rows [lo, lo+C) at root w: the ladder groups of
// ops/fused.py ladder_groups (forward from stage 0 up, inverse from the
// top group down), each group's stages then its carry.
__device__ void transform(const Col& c, int* S, int lo, int C, long long w, bool inverse,
                          bool use_pe, int kmax) {
  int D = 0;
  while ((1 << D) < C) ++D;
  const int L = c.L, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (D == 0) {       // length 1: the table's shift alone
    if (use_pe && warp == 0) {
      const long long e = pe_of(c, lo);
      const long long sh = inverse ? (c.W2 - e) % c.W2 : e;
      for (int i = lane; i < L; i += 32)
        S[i] = mf::shift_mod_digit(c.X + lo * L, i, sh, L);
      __syncwarp();
      for (int i = lane; i < L; i += 32) c.X[lo * L + i] = S[i];
    }
    return;
  }
  int done = 0;
  while (done < D) {
    const int kg = min(kmax, D - done);
    const int first = inverse ? D - done - kg : done;
    for (int jj = 0; jj < kg; ++jj) {
      const int s = inverse ? first + kg - 1 - jj : first + jj;
      stage(c, S, lo, C, s, w, inverse, use_pe && s == D - 1, jj == kg - 1);
      __syncthreads();
    }
    done += kg;
  }
}

__device__ void run_op(const Col& c, int* S, const long long* op, int kmax) {
  const int L = c.L, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kind = static_cast<int>(op[0]), lo = static_cast<int>(op[1]);
  const int n = static_cast<int>(op[2]), k = static_cast<int>(op[3]);
  const long long e1 = op[4], e2 = op[5], w = op[6];
  const bool use_pe = op[7] != 0;
  int* S0 = S;
  int* S1 = S + L;
  int* S2 = S + 2 * L;
  switch (kind) {
    case OP_FFT:
    case OP_IFFT:
      transform(c, S, lo, n, w, kind == OP_IFFT, use_pe, kmax);
      break;
    case OP_TOP_FWD:    // j < n: s = carry(a+b) (j < k), t = (a-b) z^j or a z^j
      for (int j = warp; j < n; j += c.warps) {
        int* A = c.X + (lo + j) * L;
        int* B = c.X + (lo + n + j) * L;
        const long long e = (j * w) % c.W2;
        for (int i = lane; i < L; i += 32) {
          if (j < k) S0[i] = A[i] + B[i];
          S1[i] = mf::shift_comb_digit(A, B, j < k ? -1 : 0, i, e, L);
        }
        __syncwarp();
        for (int i = lane; i < L; i += 32) {
          if (j < k) A[i] = mf::carry_digit(S0, i, L);
          B[i] = S1[i];
        }
        __syncwarp();
      }
      break;
    case OP_FOLD:       // j in [k, e1): x_j = carry(x_j + x_{j+n})
    case OP_DOUBLE:     // j < n: x_j = carry(2 x_j)
      for (int j = (kind == OP_FOLD ? k : 0) + warp; j < (kind == OP_FOLD ? e1 : n); j += c.warps) {
        int* A = c.X + (lo + j) * L;
        const int* B = kind == OP_FOLD ? c.X + (lo + n + j) * L : A;
        for (int i = lane; i < L; i += 32) S0[i] = A[i] + B[i];
        __syncwarp();
        for (int i = lane; i < L; i += 32) A[i] = mf::carry_digit(S0, i, L);
        __syncwarp();
      }
      break;
    case OP_RESTORE:
      for (int idx = threadIdx.x; idx < n * L; idx += blockDim.x)
        c.X[lo * L + idx] = c.in[lo * L + idx];
      break;
    case OP_PE_DIV:     // j < n: x_j / 2^pe(lo+j)
      for (int j = warp; j < n; j += c.warps) {
        int* A = c.X + (lo + j) * L;
        const long long e = (c.W2 - pe_of(c, lo + j)) % c.W2;
        for (int i = lane; i < L; i += 32) S0[i] = mf::shift_mod_digit(A, i, e, L);
        __syncwarp();
        for (int i = lane; i < L; i += 32) A[i] = S0[i];
        __syncwarp();
      }
      break;
    case OP_TAIL0:      // j in [k, n): t_j = s_j z^j / 2^lgh into row n+j; s_j = carry(2 s_j)
      for (int j = k + warp; j < n; j += c.warps) {
        int* A = c.X + (lo + j) * L;
        int* B = c.X + (lo + n + j) * L;
        const long long e = red(j * w - e1, c.W2);
        for (int i = lane; i < L; i += 32) {
          S0[i] = A[i] + A[i];
          S1[i] = mf::shift_mod_digit(A, i, e, L);
        }
        __syncwarp();
        for (int i = lane; i < L; i += 32) {
          A[i] = mf::carry_digit(S0, i, L);
          B[i] = S1[i];
        }
        __syncwarp();
      }
      break;
    case OP_TAIL1:      // j in [k, n), s = row j, v = row n+j:
      // t_j = (carry(s / 2^lgh - carry(2v))) z^j into row n+j,
      // row j = carry(carry(2s) - v 2^lgC)
      for (int j = k + warp; j < n; j += c.warps) {
        int* A = c.X + (lo + j) * L;
        int* B = c.X + (lo + n + j) * L;
        for (int i = lane; i < L; i += 32) {
          S0[i] = mf::shift_mod_digit(A, i, red(-e1, c.W2), L);
          S2[i] = B[i] + B[i];
        }
        __syncwarp();
        for (int i = lane; i < L; i += 32) S1[i] = S0[i] - mf::carry_digit(S2, i, L);
        __syncwarp();
        for (int i = lane; i < L; i += 32) S0[i] = mf::carry_digit(S1, i, L);
        __syncwarp();
        for (int i = lane; i < L; i += 32) {
          S1[i] = mf::shift_mod_digit(S0, i, (j * w) % c.W2, L);
          S2[i] = A[i] + A[i];
        }
        __syncwarp();
        for (int i = lane; i < L; i += 32)
          S0[i] = mf::carry_digit(S2, i, L) - mf::shift_mod_digit(B, i, e2 % c.W2, L);
        __syncwarp();
        for (int i = lane; i < L; i += 32) {
          A[i] = mf::carry_digit(S0, i, L);
          B[i] = S1[i];
        }
        __syncwarp();
      }
      break;
    case OP_BFLY_INV:   // j < k: u = t_j / z^j; carry(s_j + u), carry(s_j - u)
      for (int j = warp; j < k; j += c.warps) {
        int* A = c.X + (lo + j) * L;
        int* B = c.X + (lo + n + j) * L;
        const long long e = (c.W2 - (j * w) % c.W2) % c.W2;
        for (int i = lane; i < L; i += 32) S2[i] = mf::shift_mod_digit(B, i, e, L);
        __syncwarp();
        for (int i = lane; i < L; i += 32) {
          S0[i] = A[i] + S2[i];
          S1[i] = A[i] - S2[i];
        }
        __syncwarp();
        for (int i = lane; i < L; i += 32) {
          A[i] = mf::carry_digit(S0, i, L);
          B[i] = mf::carry_digit(S1, i, L);
        }
        __syncwarp();
      }
      break;
    case OP_OUT1:       // j < k: x_j = carry(carry(2 x_j) - x_{j+n} 2^lgC)
      for (int j = warp; j < k; j += c.warps) {
        int* A = c.X + (lo + j) * L;
        const int* B = c.X + (lo + n + j) * L;
        for (int i = lane; i < L; i += 32) S2[i] = A[i] + A[i];
        __syncwarp();
        for (int i = lane; i < L; i += 32)
          S0[i] = mf::carry_digit(S2, i, L) - mf::shift_mod_digit(B, i, e2 % c.W2, L);
        __syncwarp();
        for (int i = lane; i < L; i += 32) A[i] = mf::carry_digit(S0, i, L);
        __syncwarp();
      }
      break;
    default:
      break;
  }
  __syncthreads();
}

__global__ void mfa_cols_kernel(const int* __restrict__ x, int* __restrict__ out,
                                const long long* __restrict__ sched, int nops, int n2, int L,
                                long long n1_mask, long long wx, int kmax) {
  extern __shared__ int smem[];
  const long long b = blockIdx.x;
  const long long base = b * n2 * static_cast<long long>(L);
  int lgn2 = 0;
  while ((1 << lgn2) < n2) ++lgn2;
  Col c{smem, x + base, L, 32LL * L, wx, b & n1_mask, lgn2, static_cast<int>(blockDim.x >> 5)};
  int* S = smem + n2 * L + (threadIdx.x >> 5) * 3 * L;   // this warp's scratch rows
  for (int idx = threadIdx.x; idx < n2 * L; idx += blockDim.x) c.X[idx] = c.in[idx];
  __syncthreads();
  for (int o = 0; o < nops; ++o) run_op(c, S, sched + o * kOpFields, kmax);
  for (int idx = threadIdx.x; idx < n2 * L; idx += blockDim.x) out[base + idx] = c.X[idx];
}

}  // namespace

// x, out: (B, n2, L) int32; sched: device int64 [nops, 8] (ops/fused.py
// mfa_cols_schedule); n1_mask = n1 - 1; wx: the cross-twiddle exponent w;
// kmax: stages per carry group; warps: the CTA's warps (ops/fused.py
// MFA_COL_WARPS), which with the column set its shared memory,
// (n2 + 3 warps) L int32.
MF_EXPORT int mf_mfa_cols(const void* x, void* out, const void* sched, int nops, long long B,
                          int n2, int L, long long n1_mask, long long wx, int kmax, int warps,
                          void* stream) {
  if (n2 < 1 || (n2 & (n2 - 1)) || L < 1 || kmax < 1 || nops < 0 || warps < 1 || warps > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = (static_cast<size_t>(n2) + 3 * warps) * L * sizeof(int);
  cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(mfa_cols_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mfa_cols_kernel<<<static_cast<unsigned>(B), 32 * warps, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), static_cast<const long long*>(sched),
      nops, n2, L, n1_mask, wx, kmax);
  return static_cast<int>(cudaGetLastError());
}
