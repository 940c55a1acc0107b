// The butterfly ladder's group routine, shared by the ladder (ladder.cu) and
// the Garner kernels' post leg (ntt_links.cu).
//
// A CTA holds the K = 2^k ring elements of one block position, K rows of L
// digits, in ONE shared-memory buffer and runs the group's k radix-2 stages
// on it in place.  A stage is cut into rounds of whole butterfly pairs:
// in a round each thread reads the sources of up to P items (an item is a
// run of V digits of one pair: the rotated reads cross the row) into
// registers, the block syncs, and each thread writes its items back over
// their pair's two rows.  A pair's rows are read and written in the same
// round and by no other round of the stage, so one barrier per round and
// one per stage order every access.
//
// Each stage's twiddles are decomposed once per (stage, pair) into a small
// table (ladder_table) before the digits run; a digit run takes its
// rotation, sub-digit shift and sign from there.  With V = 4 (L % 4 == 0)
// the rows are read and written as int4, the rotated window of a run as two
// aligned int4 loads whose five wanted words are picked by two select
// rounds (no dynamic register indexing); runs map to threads by shifts
// where L and K are powers of two.  V = 1 is the general path (any L): one
// digit per item through mf::shift_comb_digit.
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

template <int V>
__device__ __forceinline__ void store_run(int* p, const int (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int t = 0; t < V; ++t) p[t] = v[t];
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

// The k stages of one ladder group, in place on buf (K rows of L digits,
// shared memory), with the tables of ladder_table: forward j = 0..k-1,
// inverse j = k-1..0, carry-free.  pe_last: the innermost stage (m == 1)
// takes the table form.  T threads (blockDim.x), each holding at most P
// items of V digits per round; the launch guarantees T*P >= L/V (one pair
// fits a round).  Every thread calls it; it starts by reading buf (the
// caller syncs before) and ends with a barrier.
template <int V, int P, int T>
__device__ __forceinline__ void ladder_group(int* buf, int K, int k, int L, bool inverse,
                                             const int* tab0, const int* tab1, bool pe_last) {
  const int half = K >> 1;
  const int ipp = L / V;                                   // items per pair
  const int lg_ipp = (ipp & (ipp - 1)) ? -1 : __ffs(ipp) - 1;
  const int G = min(T * P / ipp, half);                    // pairs per round
  const int slots = G * ipp;
  const int rounds = (half + G - 1) / G;
  for (int jj = 0; jj < k; ++jj) {
    const int j = inverse ? k - 1 - jj : jj;
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
        const int pl = lg_ipp >= 0 ? s >> lg_ipp : s / ipp;
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

// The deferred carry of a group and the store: out[base + q*rstride + i] =
// carry_digit(row q of buf, i) for the K rows of L digits.  Reads only buf,
// writes only out (global).
template <int V, int T>
__device__ __forceinline__ void carry_store(const int* buf, int K, int L, int* out,
                                            long long base, long long rstride) {
  const int cpr = L / V;                                   // runs per row
  const int lg = (cpr & (cpr - 1)) ? -1 : __ffs(cpr) - 1;
  for (int idx = threadIdx.x; idx < K * cpr; idx += T) {
    const int q = lg >= 0 ? idx >> lg : idx / cpr;
    const int i0 = (idx - q * cpr) * V;
    const int* row = buf + q * L;
    int v[V], o[V];
    load_run<V>(row + i0, v);
    int prev = row[i0 == 0 ? L - 1 : i0 - 1];
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const int c = prev >> DIGIT_BITS;
      o[t] = (v[t] & DIGIT_MASK) + (i0 + t == 0 ? -c : c);
      prev = v[t];
    }
    store_run<V>(out + base + q * rstride + i0, o);
  }
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
