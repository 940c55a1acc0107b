// Rows held by one CTA or by a thread-block cluster of R CTAs, and the whole
// radix-2 transform run on them: shared by the MFA column kernel
// (mfa_cols.cu) and the whole-row transform's wide rows (transform_small.cu).
//
// A set of n rows of L digits lives in ONE in-place buffer per CTA: CTA rank
// r of the cluster holds rows [r * rpc, (r+1) * rpc), rpc = n / R, and reads
// the others' through distributed shared memory (Rows::row).  A transform of
// C rows runs the ladder groups of ops/fused.py ladder_groups (at most kmax
// stages each, the in-place carry after each): the stages whose pairs lie
// inside a CTA on csrc/ladder_group.cuh's group routine, the stages whose
// pairs span two CTAs (m rows apart >= rpc: the forward's first log2(R)
// stages, the inverse's last) row by row -- each CTA computes its own rows'
// new digits, reading the partner row through distributed shared memory, a
// cluster barrier between the reads and the writes.  The twiddles are tabled
// once per (stage, pair) from the C/2 exponents u w mod 2W; with use_pe the
// rows' exponent table rides the forward's last stage and the inverse's first
// (the MFA's cross twiddles).  The integer sequence is ladder_plain's, group
// by group, so the raw digits are the plain version's.
#pragma once

#include <cooperative_groups.h>

#include "ladder_group.cuh"

namespace mf {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;

// One CTA's view of its rows: its own rows [rank * rpc, (rank+1) * rpc) in
// buf, the rest of the cluster's through row().
struct Rows {
  int* buf;            // this CTA's rows, rpc rows of L digits
  const int* in;       // the rows' input (global; the column kernel's RESTORE)
  const int* pe;       // the rows' exponent table (shared), or null
  int* ew;             // the current transform's exponents u*w mod 2W
  int* tab0;           // its ladder tables, this CTA's frame
  int* tab1;
  long long W2;        // 2W
  int L, rpc, lg_rpc, rank, R;

  // row q of the set, in this CTA or another of the cluster
  __device__ __forceinline__ const int* row(int q) const {
    const int rk = q >> lg_rpc;
    int* p = buf + (q - (rk << lg_rpc)) * L;
    return rk == rank ? p : cg::this_cluster().map_shared_rank(p, rk);
  }
  // every thread of the set's CTAs
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

// The ints of one ladder table of a CTA holding rpc rows: log2(rpc) stages
// of rpc/2 pairs (at least one).
__host__ __device__ inline int rows_tab_ints(int rpc) {
  int lg = 0;
  while ((1 << lg) < rpc) ++lg;
  return (lg > 1 ? lg : 1) * (rpc > 2 ? rpc / 2 : 1);
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
__device__ __forceinline__ void row_pass(const Rows& c, int nrows, int span, Map map, F f) {
  const int ipp = c.L / V;
  const int lg_ipp = div_lg(ipp);
  const unsigned mg_ipp = div_magic(ipp);
  int G = T * P / ipp;
  if (!CROSS && G > 1) G &= ~1;
  const int rounds = (span + G - 1) / G;
  for (int r = 0; r < rounds; ++r) {
    int o[P][V], at[P];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int s = u * T + static_cast<int>(threadIdx.x);
      const int sl = div_small(s, lg_ipp, mg_ipp);
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
      if (at[u] >= 0) store_run<V>(c.buf + at[u], o[u]);
  }
}

// Stage j of the transform [lo, lo+C) whose pairs (m = C >> (j+1) rows
// apart, m >= rpc) span two CTAs: each CTA's rows are all on one side.
// Every CTA of the cluster calls it; it ends with the CTA in step.
template <int V, int P, int T>
__device__ void cross_stage(const Rows& c, int lo, int C, int j, bool inverse) {
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
            twist<V, -1>(A, B, i0, e, c.L, o);
          } else {
            int a[V], b[V];
            load_run<V>(A + i0, a);
            load_run<V>(B + i0, b);
#pragma unroll
            for (int t = 0; t < V; ++t) o[t] = a[t] + b[t];
          }
        } else {
          int a[V], u[V];
          twist<V, 0>(B, nullptr, i0, neg_exp(e, c.W2), c.L, u);
          load_run<V>(A + i0, a);
#pragma unroll
          for (int t = 0; t < V; ++t) o[t] = b_side ? a[t] - u[t] : a[t] + u[t];
        }
        return true;
      });
  __syncthreads();
}

// A whole transform of rows [lo, lo+C) at root w: the ladder groups of
// ops/fused.py ladder_groups (forward from stage 0 up, inverse from the top
// group down), each group's stages then its carry; the table at its last /
// first stage where use_pe.  This CTA's part: all of it where C <= rpc
// (only lo's CTA works), else its own rows, the stages whose pairs cross
// CTAs (j < xs) by cross_stage, the rest on the group routine.  Every CTA
// calls it; it ends with the CTA, not the cluster, in step (a caller whose
// next reads cross CTAs syncs the cluster first).
template <int V, int P, int T>
__device__ void run_transform(const Rows& c, int lo, int C, long long w, bool inverse,
                              bool use_pe, int kmax) {
  const int L = c.L;
  int D = 0;
  while ((1 << D) < C) ++D;
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
      ladder_group<V, P, T>(lbuf, Kl, kl, L, inverse, c.tab0, c.tab1, use_pe, l0 - xs,
                            j0 + kg - l0);
    if (inverse)
      for (int j = x1 - 1; j >= j0; --j) cross_stage<V, P, T>(c, lo, C, j, true);
    if (active) carry_rows<V, P, T>(lbuf, Kl, L);
    done += kg;
  }
}

// Launch kernel on B sets of rows, R CTAs a set (a thread-block cluster
// where R > 1), T threads and smem bytes of dynamic shared memory a CTA,
// with the shared-memory limit raised first; CUDA's error where the card
// cannot hold the block or the cluster (cleared from the thread's last
// error, so that it does not surface at a later launch).
template <class... Params, class... Args>
cudaError_t launch_rows(void (*kernel)(Params...), long long B, int R, int T, size_t smem,
                        void* stream, Args... args) {
  cudaError_t err = prepare_group_kernel(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * R));
  cfg.blockDim = dim3(static_cast<unsigned>(T));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(R);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = R > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

}  // namespace mf
