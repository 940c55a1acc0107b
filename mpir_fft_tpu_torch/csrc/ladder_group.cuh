// The butterfly ladder's group routine, shared by the ladder (ladder.cu), the
// Garner kernels' post leg (ntt_links.cu) and the whole-row transform
// (transform_small.cu), and the half-bit twiddle of a run of digits, shared
// by the ladder's pre_half, the whole-row transform's options and the
// standalone twiddle (twiddle_half.cu).
//
// A CTA holds the K = 2^k ring elements of one block position, K rows of L
// digits, in ONE shared-memory buffer and runs the group's radix-2 stages
// on it in place (all k, or a range of them: the whole-row transform holds
// its C rows as one K = C group and runs its ladder groups as stage ranges,
// an in-place carry between them).  A stage is cut into rounds of whole
// butterfly pairs: in a round each thread reads the sources of up to P items
// (an item is a run of V digits of one pair: the rotated reads cross the
// row) into registers, the block syncs, and each thread writes its items
// back over their pair's two rows.  A pair's rows are read and written in
// the same round and by no other round of the stage, so one barrier per
// round and one per stage order every access.
//
// Each stage's twiddles are decomposed once per (stage, pair) into a small
// table (ladder_table) before the digits run; a digit run takes its
// rotation, sub-digit shift and sign from there.  With V = 4 (L % 4 == 0)
// the rows are read and written as int4, the rotated window of a run as two
// aligned int4 loads whose five wanted words are picked by two select
// rounds (no dynamic register indexing).  Item u of thread t is slot
// u*T + t of the round, so a warp's items are consecutive runs (pairs'
// rows side by side): its 16-byte accesses hit distinct banks.  (A layout
// that kept one pair per thread for every stage, its shifts decoded once,
// put rows 3-4 threads apart on the same banks and ran twice as slow.)
// V = 1 is the general path (any L): one digit per item through
// mf::shift_comb_digit.
//
// The integer sequence is the plain version's (ops/fused.py ladder_plain):
// every output digit is the shift_comb_digit / butterfly_digit expression
// of the same operands, so the raw digits agree exactly.
#pragma once

#include "common.cuh"

namespace mf {

// The stage exponents of one ladder group (at most kMaxLadderStages stages).
constexpr int kMaxLadderStages = 8;
struct LadderSteps {
  long long s[kMaxLadderStages];
};

// n / d for 0 <= n, d < 2^16 where d is not a power of two: one multiply-high
// by magic = floor(2^32 / d) + 1, exact in that range (the error n (magic d -
// 2^32) / 2^32 stays below 1/d).  div_magic(d) is 0 for a power of two d,
// whose quotient is a shift by lg = log2(d) (div_lg, else -1).
__host__ __device__ __forceinline__ unsigned div_magic(unsigned d) {
  return (d & (d - 1)) ? 0xFFFFFFFFu / d + 1 : 0;
}
__device__ __forceinline__ int div_lg(unsigned d) {
  return (d & (d - 1)) ? -1 : __ffs(static_cast<int>(d)) - 1;
}
__device__ __forceinline__ int div_small(int n, int lg, unsigned magic) {
  return lg >= 0 ? n >> lg : static_cast<int>(__umulhi(static_cast<unsigned>(n), magic));
}

// Dynamic shared memory of a ladder-group CTA: the K*L-digit buffer, the
// two twiddle tables of k*K/2 ints each and K per-row pre_half exponents.
// This is the kernels' layout; which groups launch is the host's rule
// (ops/fused.py ladder_fits: the buffer within 64 KB), and a block the
// card cannot hold fails in prepare_group_kernel with CUDA's own error.
inline size_t ladder_smem_bytes(int K, int k, int L) {
  return sizeof(int) * (static_cast<size_t>(K) * L + static_cast<size_t>(k) * K + K);
}

template <int V>
__device__ __forceinline__ void load_run(const int* p, int (&v)[V]) {
  if constexpr (V == 4) {
    const int4 t = *reinterpret_cast<const int4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) v[t] = p[t];
  }
}

// CS: streaming stores (evict first: the data is not read again soon).
template <int V, bool CS = false>
__device__ __forceinline__ void store_run(int* p, const int (&v)[V]) {
  if constexpr (V == 4) {
    const int4 t = make_int4(v[0], v[1], v[2], v[3]);
    if constexpr (CS)
      __stcs(reinterpret_cast<int4*>(p), t);
    else
      *reinterpret_cast<int4*>(p) = t;
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) {
      if constexpr (CS)
        __stcs(p + t, v[t]);
      else
        p[t] = v[t];
    }
  }
}

// 16 bytes from device memory into shared memory without registers
// (cp.async, L2 only); cp_async_wait_all waits for this thread's copies.
__device__ __forceinline__ void cp_async16(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Digits i0 .. i0+V-1 of shift_mod(A + SGN * B, s), s in [0, 2W), SGN in
// {-1, 0, 1} (B unread at 0): shift_comb_digit of each.  V == 4 needs
// L % 4 == 0, i0 % 4 == 0 and 16-byte aligned rows (shared or global).
template <int V, int SGN>
__device__ __forceinline__ void twist(const int* A, const int* B, int i0, int s, int L,
                                      int (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = shift_comb_digit(A, B, SGN, i0, s, L);
  } else {
    static_assert(V == 4, "runs of 1 or 4 digits");
    const int W = DIGIT_BITS * L;
    const bool neg = s >= W;
    const int r = neg ? s - W : s;
    const int kd = r >> 4, b = r & 15, sh = DIGIT_BITS - b;
    // sources of the destinations i0-1 .. i0+3 (i0-1 = L-1 at i0 == 0):
    // five consecutive digits mod L from s0, inside two aligned chunks
    int s0 = i0 - 1 - kd;
    if (s0 < 0) s0 += L;
    const int c0 = s0 & ~3, o = s0 & 3;
    const int c1 = c0 + 4 == L ? 0 : c0 + 4;
    const int4 a0 = *reinterpret_cast<const int4*>(A + c0);
    const int4 a1 = *reinterpret_cast<const int4*>(A + c1);
    int x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    if constexpr (SGN != 0) {
      const int4 b0 = *reinterpret_cast<const int4*>(B + c0);
      const int4 b1 = *reinterpret_cast<const int4*>(B + c1);
      const int y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int t = 0; t < 8; ++t) x[t] = SGN > 0 ? x[t] + y[t] : x[t] - y[t];
    }
    int y[7];
#pragma unroll
    for (int t = 0; t < 7; ++t) y[t] = (o & 1) ? x[t + 1] : x[t];
    int v[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      v[t] = (o & 2) ? y[t + 2] : y[t];
      const int j = i0 - 1 + t;          // destinations below kd wrapped: negated
      if (j >= 0 && j < kd) v[t] = -v[t];
    }
    const int lo = (1 << sh) - 1;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int hi_prev = v[t] >> sh;
      const int d = shl(v[t + 1] & lo, b) + (i0 + t == 0 ? -hi_prev : hi_prev);
      out[t] = neg ? -d : d;
    }
  }
}

// The twiddle tables of one group: entry j*K/2 + p for stage j, pair p
// (K-indices qa = (p / m) 2m + p % m and qb = qa + m, m = K >> (j+1)), with
// e = ((p % m) h + hpos) steps[j] mod 2W:
//   tab1: the exponent of the twisted row -- e (forward: t = (a - b) 2^e),
//         2W - e (inverse: u = b 2^-e); at the table stage (pe, m == 1)
//         e1 = e + pe1 (forward) or 2W - e1 (inverse);
//   tab0: at the table stage only, pe0 (forward: s = (a + b) 2^pe0) or
//         2W - pe0 (inverse: a' = a 2^-pe0).
// pe: this block's (K/2, 2) table, or null.  Every thread calls it; the
// caller syncs before the tables are read.
__device__ inline void ladder_table(int* tab0, int* tab1, int K, int k, int L, long long h,
                                    long long hpos, bool inverse, const LadderSteps& steps,
                                    const int* pe) {
  const long long W2 = 32LL * L;
  const int half = K >> 1;
  for (int t = threadIdx.x; t < k * half; t += blockDim.x) {
    const int j = t / half, p = t - j * half;
    const int m = K >> (j + 1);
    const long long e = ((static_cast<long long>(p % m) * h + hpos) * steps.s[j]) % W2;
    long long s0 = 0, s1 = e;
    if (pe != nullptr && m == 1) {
      s0 = pe[2 * p];
      s1 = (e + pe[2 * p + 1]) % W2;
    }
    if (inverse) {
      s0 = (W2 - s0) % W2;
      s1 = (W2 - s1) % W2;
    }
    tab0[t] = static_cast<int>(s0);
    tab1[t] = static_cast<int>(s1);
  }
}

// One item: the new digits of rows qa (oa) and qb (ob) at i0 .. i0+V-1.
// mode bit 0: inverse; bit 1: the table stage.
//   0  fwd:        oa = a + b,             ob = (a - b) 2^s1
//   1  inv:        u = b 2^s1,             oa = a + u, ob = a - u
//   2  fwd, table: oa = (a + b) 2^s0,      ob = (a - b) 2^s1
//   3  inv, table: a' = a 2^s0, u = b 2^s1, oa = a' + u, ob = a' - u
template <int V>
__device__ __forceinline__ void ladder_item(int mode, const int* A, const int* B, int i0, int s0,
                                            int s1, int L, int (&oa)[V], int (&ob)[V]) {
  int a[V], u[V];
  switch (mode) {
    case 0:
      load_run<V>(A + i0, a);
      load_run<V>(B + i0, u);
#pragma unroll
      for (int t = 0; t < V; ++t) oa[t] = a[t] + u[t];
      twist<V, -1>(A, B, i0, s1, L, ob);
      return;
    case 1:
      load_run<V>(A + i0, a);
      twist<V, 0>(B, nullptr, i0, s1, L, u);
      break;
    case 2:
      twist<V, 1>(A, B, i0, s0, L, oa);
      twist<V, -1>(A, B, i0, s1, L, ob);
      return;
    default:
      twist<V, 0>(A, nullptr, i0, s0, L, a);
      twist<V, 0>(B, nullptr, i0, s1, L, u);
      break;
  }
#pragma unroll
  for (int t = 0; t < V; ++t) {
    oa[t] = a[t] + u[t];
    ob[t] = a[t] - u[t];
  }
}

// Stages j0 .. j0+kg-1 of the k of one ladder group, in place on buf (K rows
// of L digits, shared memory), with the tables of ladder_table: forward
// ascending, inverse descending, carry-free (the ladder and the post leg run
// all k: j0 = 0, kg = k).  pe_last: the innermost stage (m == 1) takes the
// table form.  T threads (blockDim.x), each holding at most P items of V
// digits per round; the launch guarantees T*P >= L/V (one pair fits a
// round), and the rounds of a stage share its pairs evenly.  Every thread
// calls it; it starts by reading buf (the caller syncs before) and ends with
// a barrier.
template <int V, int P, int T>
__device__ __forceinline__ void ladder_group(int* buf, int K, int k, int L, bool inverse,
                                             const int* tab0, const int* tab1, bool pe_last,
                                             int j0, int kg) {
  const int half = K >> 1;
  const int ipp = L / V;                                   // items per pair
  const int lg_ipp = div_lg(ipp);
  const unsigned mg_ipp = div_magic(ipp);
  const int rounds = (half + T * P / ipp - 1) / (T * P / ipp);
  const int G = (half + rounds - 1) / rounds;              // pairs per round
  const int slots = G * ipp;
  for (int jj = 0; jj < kg; ++jj) {
    const int j = inverse ? j0 + kg - 1 - jj : j0 + jj;
    const int lgm = k - 1 - j;
    const int mL = L << lgm;                                 // m rows apart
    const int mode = (inverse ? 1 : 0) | (pe_last && lgm == 0 ? 2 : 0);
    const int* t0 = tab0 + j * half;
    const int* t1 = tab1 + j * half;
    for (int r = 0; r < rounds; ++r) {
      int oa[P][V], ob[P][V], at[P];
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const int s = u * T + static_cast<int>(threadIdx.x);
        const int pl = div_small(s, lg_ipp, mg_ipp);
        const int p = r * G + pl;
        at[u] = -1;
        if (s < slots && p < half) {
          const int i0 = (s - pl * ipp) * V;
          const int qa = ((p >> lgm) << (lgm + 1)) + (p & ((1 << lgm) - 1));
          const int* A = buf + qa * L;
          at[u] = qa * L + i0;
          ladder_item<V>(mode, A, A + mL, i0, t0[p], t1[p], L, oa[u], ob[u]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < P; ++u) {
        if (at[u] >= 0) {
          store_run<V>(buf + at[u], oa[u]);
          store_run<V>(buf + at[u] + mL, ob[u]);
        }
      }
    }
    __syncthreads();
  }
}

// Digits i0 .. i0+V-1 of carry_pass(row) (mf::carry_digit of each).
template <int V>
__device__ __forceinline__ void carry_run(const int* row, int i0, int L, int (&o)[V]) {
  int v[V];
  load_run<V>(row + i0, v);
  int prev = row[i0 == 0 ? L - 1 : i0 - 1];
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int c = prev >> DIGIT_BITS;
    o[t] = (v[t] & DIGIT_MASK) + (i0 + t == 0 ? -c : c);
    prev = v[t];
  }
}

// The deferred carry of a group and the store: out[base + q*rstride + i] =
// carry_digit(row q of buf, i) for the K rows of L digits.  Reads only buf,
// writes only out (global).
template <int V, int T>
__device__ __forceinline__ void carry_store(const int* buf, int K, int L, int* out,
                                            long long base, long long rstride) {
  const int cpr = L / V;                                   // runs per row
  const int lg = div_lg(cpr);
  const unsigned mg = div_magic(cpr);
  for (int idx = threadIdx.x; idx < K * cpr; idx += T) {
    const int q = div_small(idx, lg, mg);
    const int i0 = (idx - q * cpr) * V;
    int o[V];
    carry_run<V>(buf + q * L, i0, L, o);
    store_run<V>(out + base + q * rstride + i0, o);
  }
}

// The deferred carry in place: each of the R rows of L digits of buf
// becomes carry_pass(row).  Rounds of whole rows (runs into registers, a
// barrier, the writes), at most P runs a thread; T*P >= L/V as for
// ladder_group.  Every thread calls it; it ends with a barrier.
template <int V, int P, int T>
__device__ __forceinline__ void carry_rows(int* buf, int R, int L) {
  const int cpr = L / V;
  const int lg = div_lg(cpr);
  const unsigned mg = div_magic(cpr);
  const int rounds = (R + T * P / cpr - 1) / (T * P / cpr);
  const int G = (R + rounds - 1) / rounds;                 // rows per round
  for (int r = 0; r < rounds; ++r) {
    int o[P][V], at[P];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int s = u * T + static_cast<int>(threadIdx.x);
      const int ql = div_small(s, lg, mg);
      const int q = r * G + ql;
      at[u] = -1;
      if (ql < G && q < R) {
        const int i0 = (s - ql * cpr) * V;
        at[u] = q * L + i0;
        carry_run<V>(buf + q * L, i0, L, o[u]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < P; ++u)
      if (at[u] >= 0) store_run<V>(buf + at[u], o[u]);
  }
  __syncthreads();
}

// Digit j of the odd half-bit twiddle's pre-carry row t2 = hi - lo of the
// row x (twiddle_half_run below): hi, lo the static rotations by 3L/4 and L/4
// digits of base = shift_mod(x, k) when L % 4 == 0, else the two sub-digit
// shift_mods of x.
__device__ __forceinline__ int half_t2(const int* x, int j, long long k, int L) {
  if (L % 4 == 0) {
    const int kh = 3 * L / 4, kl = L / 4;
    const int hi = j >= kh ? shift_mod_digit(x, j - kh, k, L)
                           : -shift_mod_digit(x, L - kh + j, k, L);
    const int lo = j >= kl ? shift_mod_digit(x, j - kl, k, L)
                           : -shift_mod_digit(x, L - kl + j, k, L);
    return hi - lo;
  }
  const long long W = 16LL * L;
  return shift_mod_digit(x, j, (k + 3 * W / 4) % (2 * W), L) -
         shift_mod_digit(x, j, (k + W / 4) % (2 * W), L);
}

// r[t] = rot_digit(base, i0 - 1 + t, kdig) for t = 0..4 (i0 - 1 = L - 1 at
// i0 == 0), base = shift_mod(x, k), for i0 and kdig multiples of 4: the
// rotated run as one aligned 4-digit twist and the digit below it.
__device__ __forceinline__ void rot_base_run(const int* x, int i0, int kdig, int k, int L,
                                             int (&r)[5]) {
  int p0 = i0 - kdig;
  if (p0 < 0) p0 += L;
  int b4[4];
  twist<4, 0>(x, nullptr, p0, k, L, b4);
  const int bm = shift_mod_digit(x, p0 == 0 ? L - 1 : p0 - 1, k, L);
  r[0] = (i0 == 0 ? L - 1 : i0 - 1) >= kdig ? bm : -bm;
#pragma unroll
  for (int t = 0; t < 4; ++t) r[t + 1] = i0 >= kdig ? b4[t] : -b4[t];
}

// Digits i0 .. i0+V-1 of x * 2^(e2/2) mod 2^(16L)+1 (one row of L digits,
// shared or global memory; 16-byte aligned for V == 4), half-bit exponent
// e2 in [0, 4W): shift_mod(x, e2/2) for even e2, else carry_pass(t2), where
// 2^(k + 1/2) = 2^(k + 3W/4) - 2^(k + W/4) and hi, lo are the static
// rotations by 3L/4 and L/4 digits of base = shift_mod(x, k) when L % 4 ==
// 0, else the two sub-digit shift_mods of x -- the row body of the
// reference's _twiddle_half_rows (fused.py:714-736) and of the plain
// version ops/fused.py twiddle_half_rows_plain, run by run.
template <int V>
__device__ __forceinline__ void twiddle_half_run(const int* x, int i0, int e2, int L,
                                                 int (&v)[V]) {
  const long long k = e2 >> 1;
  if (!(e2 & 1)) {
    twist<V, 0>(x, nullptr, i0, static_cast<int>(k), L, v);
    return;
  }
  if constexpr (V == 4) {
    if (L % 16 == 0) {        // the static rotations 3L/4, L/4 keep runs aligned
      int hi[5], lo[5];
      rot_base_run(x, i0, 3 * L / 4, static_cast<int>(k), L, hi);
      rot_base_run(x, i0, L / 4, static_cast<int>(k), L, lo);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = (hi[t] - lo[t]) >> DIGIT_BITS;
        v[t] = ((hi[t + 1] - lo[t + 1]) & DIGIT_MASK) + (i0 + t == 0 ? -c : c);
      }
      return;
    }
  }
  int prev = half_t2(x, i0 == 0 ? L - 1 : i0 - 1, k, L);
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int cur = half_t2(x, i0 + t, k, L);
    const int c = prev >> DIGIT_BITS;
    v[t] = (cur & DIGIT_MASK) + (i0 + t == 0 ? -c : c);
    prev = cur;
  }
}

// Half-bit exponent (e0 + j * step) mod 4W of transform position or row j,
// e0 and step in [0, 4W) (the pre_half / post_half and twiddle_half tables).
__device__ __forceinline__ int half_exp(long long j, long long e0, long long step, int L) {
  const long long M4 = 64LL * L;
  return static_cast<int>((e0 + mulmod_small(j, step, M4)) % M4);
}

// Threads of a group launch whose pairs run ipp items, P per thread: 256
// (three such blocks share an SM at the host's 64 KB buffer) where one pair
// fits them, else tmax; 0 where one pair does not fit tmax threads either
// (ladder_group needs a whole pair per round).
inline int group_threads(int ipp, int P, int tmax) {
  return ipp <= 256 * P ? 256 : ipp <= tmax * P ? tmax : 0;
}

// Launch a ladder-group kernel: the dynamic shared-memory limit raised to
// smem, and the carveout set to shared memory's maximum so that several
// 64 KB blocks share an SM.
inline cudaError_t prepare_group_kernel(const void* kernel, size_t smem) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace mf
