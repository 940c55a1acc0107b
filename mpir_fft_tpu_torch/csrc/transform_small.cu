// A whole radix-2 transform of each (C, L) batch row in one launch, the row
// resident in shared memory through all log2(C) stages, with the negacyclic
// weights as an option.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_batched (fused.py:171-197,
// pallas_call :187) as ops/transforms.py uses it for fft_radix2 /
// ifft_radix2: the recursive mulmod's inner negacyclic transforms, and every
// batched transform whose row is small; with pre_half / post_half also
// fused.py fused_twiddle_half (:533, pallas_call :562) around it, the
// weighting of mpir_fft_tpu/ops/negacyclic.py:27-43.  Plain version:
// ops/fused.py transform_plain (the ladder groups, with twiddle_half_rows_plain
// before / after for the options), whose integer sequence this kernel
// repeats, so the raw digits agree exactly.  The rows: every (C, L) row the
// reference fuses (L <= 1024, padded row within 512 KB) and every row of at
// most 64 KB (ops/fused.py whole_fits).
//
// Stage s (forward s = 0..D-1, inverse s = D-1..0) pairs positions
// (qa, qa + half), half = C >> (s+1), with twiddle exponent e = (qa mod half)
// * (w << s) mod 2W:  fwd s = a + b, t = (a - b) 2^e;  inv u = b / 2^e,
// a' = a + u, b' = a - u.  The stages run in the groups of ops/fused.py
// ladder_groups (at most kmax stages each), with one carry pass after every
// group: the deferred-carry growth ~2^(18+k) of fused.py:472-476 stays inside
// int32 and the carries fall where the ladder launches put them.  Options:
// pre_half = (e0, step2), forward: row j is first multiplied by
// 2^((e0 + j*step2)/2) (half-bit exponents); post_half, inverse: after the
// last carry, row j is multiplied so before the store.
//
// What bounds it on an H100: device memory for the row's one read and one
// write against ~log2(C) in-place stages of shared-memory traffic and
// integer issue per digit (8 stages at the main path's C 256).  Two layouts,
// chosen here from the row's bytes and the wrapper's R (the CTAs a row,
// ops/fused.py whole_cluster):
//   * small rows (C*L*4 <= 64 KB, R 1): one CTA per row holds it in ONE C*L
//     buffer and runs it as one K = C ladder group (csrc/ladder_group.cuh:
//     stages in rounds of whole pairs, int4 runs, twiddles tabled per
//     (stage, pair)), each ladder group a stage range, the carry between
//     groups in place.  256 threads at most 64 registers each, so four CTAs
//     share an SM where the buffer lets them: at (256, 48) and (256, 32),
//     three at (256, 64); against three CTAs of 77 registers this was 3-10%
//     faster at L 32, 48 and 72 and tied at L 64 (PERF.md).
//   * wide rows (to the reference's 512 KB): one CTA of 512 threads, or a
//     thread-block cluster of R = 2, 4 or 8, C/R contiguous rows each,
//     through csrc/cluster_rows.cuh's run_transform -- the routine of the
//     MFA column kernel: the stages inside a CTA on the same group routine,
//     the stages whose pairs span CTAs row by row through distributed
//     shared memory.  One CTA an SM (128 registers a thread).
// The table comes from the C/2 distinct exponents u*w mod 2W (an entry is
// (p mod half) << s of them), so the CTA does C/2 64-bit reductions, not one
// per (stage, pair).  The row loads with cp.async and stores as 16-byte
// vectors; pre_half reads its rotated sources from device memory (L1) into
// the buffer, post_half from the buffer on the way out (mf::twiddle_half_run,
// the ladder's pre_half routine).
#include "cluster_rows.cuh"

namespace {

// The C*L buffer, the D*C/2 twiddle table, the C/2 exponents u*w mod 2W and
// the C half-bit row exponents, ints.
size_t transform_smem_bytes(int C, int D, int L) {
  return sizeof(int) * (static_cast<size_t>(C) * L + static_cast<size_t>(D) * (C / 2) + C / 2 + C);
}

template <int V, int P, int T>
__global__ void __launch_bounds__(T, T == 256 ? 4 : 1)
transform_small_kernel(const int* __restrict__ x, int* __restrict__ out, int C, int D, int L,
                       long long w, int inverse, int kmax, int half_on, long long e0,
                       long long step2) {
  extern __shared__ int4 smem4[];
  int* buf = reinterpret_cast<int*>(smem4);
  const int half = C >> 1;
  int* tab = buf + C * L;
  int* ew = tab + D * half;
  int* hexp = ew + half;
  const long long W2 = 32LL * L;
  const long long base = static_cast<long long>(blockIdx.x) * C * L;

  for (int u = threadIdx.x; u < half; u += T) ew[u] = static_cast<int>((u * w) % W2);
  if (half_on)
    for (int q = threadIdx.x; q < C; q += T) hexp[q] = mf::half_exp(q, e0, step2, L);
  __syncthreads();
  // entry s*half + p: exponent (p mod m) << s of ew, m = C >> (s+1); the
  // inverse twists by 2W - e
  const int lg_half = __ffs(half) - 1;
  for (int t = threadIdx.x; t < D * half; t += T) {
    const int s = t >> lg_half, p = t & (half - 1);
    const int e = ew[(p & ((half >> s) - 1)) << s];
    tab[t] = inverse && e ? static_cast<int>(W2) - e : e;
  }
  const int cpr = L / V;
  const int lg = mf::div_lg(cpr);
  const unsigned mg = mf::div_magic(cpr);
  for (int idx = threadIdx.x; idx < C * cpr; idx += T) {
    const int q = mf::div_small(idx, lg, mg);
    const int i0 = (idx - q * cpr) * V;
    const int* xr = x + base + q * L;
    int v[V];
    if (half_on && !inverse) {
      mf::twiddle_half_run<V>(xr, i0, hexp[q], L, v);
    } else if constexpr (V == 4) {
      mf::cp_async16(buf + q * L + i0, xr + i0);   // every row chunk in flight at once
      continue;
    } else {
      mf::load_run<V>(xr + i0, v);
    }
    mf::store_run<V>(buf + q * L + i0, v);
  }
  if constexpr (V == 4) mf::cp_async_wait_all();
  __syncthreads();

  // groups in ladder_groups order: forward from stage 0 up, inverse from
  // the top group down, each group's stages then one carry pass
  for (int done = 0; done < D;) {
    const int kg = min(kmax, D - done);
    mf::ladder_group<V, P, T>(buf, C, D, L, inverse != 0, tab, tab, false,
                              inverse ? D - done - kg : done, kg);
    done += kg;
    if (done < D) mf::carry_rows<V, P, T>(buf, C, L);
  }
  if (half_on && inverse) {
    mf::carry_rows<V, P, T>(buf, C, L);
    for (int idx = threadIdx.x; idx < C * cpr; idx += T) {
      const int q = mf::div_small(idx, lg, mg);
      const int i0 = (idx - q * cpr) * V;
      int v[V];
      mf::twiddle_half_run<V>(buf + q * L, i0, hexp[q], L, v);
      mf::store_run<V>(out + base + q * L + i0, v);
    }
  } else {
    mf::carry_store<V, T>(buf, C, L, out, base, L);
  }
}

template <int V, int P, int T>
int launch(const void* x, void* out, long long B, int C, int D, int L, long long w, int inverse,
           int kmax, int half_on, long long e0, long long step2, void* stream) {
  const auto kernel = transform_small_kernel<V, P, T>;
  const size_t smem = transform_smem_bytes(C, D, L);
  cudaError_t err = mf::prepare_group_kernel(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(B), T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), C, D, L, w, inverse, kmax, half_on,
      e0, step2);
  return static_cast<int>(cudaGetLastError());
}

// The small layout's limit: a row of at most 64 KB in one CTA, several an SM.
constexpr size_t kSmallRowBytes = 64 * 1024;
// threads a CTA of the wide layout: 128 registers each hold one CTA an SM
constexpr int kWideThreads = 512;

// A wide-row CTA's ints: its rpc rows, the C/2 exponents u*w mod 2W, the
// two ladder tables and the rpc half-bit row exponents (ops/fused.py
// whole_smem_bytes).
size_t wide_smem_bytes(int C, int rpc, int L) {
  return sizeof(int) * (static_cast<size_t>(rpc) * L + C / 2 + 2 * mf::rows_tab_ints(rpc) + rpc);
}

template <int V, int P, int T = kWideThreads>
__global__ void __launch_bounds__(T, 1)
transform_small_wide_kernel(const int* __restrict__ x, int* __restrict__ out, int C, int L,
                            long long w, int inverse, int kmax, int half_on, long long e0,
                            long long step2, int R) {
  extern __shared__ int4 smem4[];
  const int rpc = C / R;
  int lg_rpc = 0;
  while ((1 << lg_rpc) < rpc) ++lg_rpc;
  const int rank = static_cast<int>(blockIdx.x % R);
  const int first = rank * rpc;
  // this CTA's rows of row blockIdx.x / R
  const long long base = (static_cast<long long>(blockIdx.x / R) * C + first) * L;
  int* buf = reinterpret_cast<int*>(smem4);
  int* ew = buf + rpc * L;
  int* tab0 = ew + C / 2;
  int* tab1 = tab0 + mf::rows_tab_ints(rpc);
  int* hexp = tab1 + mf::rows_tab_ints(rpc);
  const mf::Rows c{buf, nullptr, nullptr, ew, tab0, tab1, 32LL * L, L, rpc, lg_rpc, rank, R};

  if (half_on)
    for (int q = threadIdx.x; q < rpc; q += T) hexp[q] = mf::half_exp(first + q, e0, step2, L);
  __syncthreads();
  const int cpr = L / V;
  const int lg = mf::div_lg(cpr);
  const unsigned mg = mf::div_magic(cpr);
  for (int idx = threadIdx.x; idx < rpc * cpr; idx += T) {
    const int q = mf::div_small(idx, lg, mg);
    const int i0 = (idx - q * cpr) * V;
    const int* xr = x + base + static_cast<long long>(q) * L;
    int v[V];
    if (half_on && !inverse) {
      mf::twiddle_half_run<V>(xr, i0, hexp[q], L, v);
    } else if constexpr (V == 4) {
      mf::cp_async16(buf + q * L + i0, xr + i0);
      continue;
    } else {
      mf::load_run<V>(xr + i0, v);
    }
    mf::store_run<V>(buf + q * L + i0, v);
  }
  if constexpr (V == 4) mf::cp_async_wait_all();
  // run_transform syncs the CTA before its first local read and the
  // cluster before its first read of another CTA's rows; every such read
  // precedes a cluster barrier that this CTA takes part in, so no CTA
  // leaves while another still reads its rows
  mf::run_transform<V, P, T>(c, 0, C, w, inverse != 0, false, kmax);
  // the last group's carry ran in place: store, post_half on the way out
  for (int idx = threadIdx.x; idx < rpc * cpr; idx += T) {
    const int q = mf::div_small(idx, lg, mg);
    const int i0 = (idx - q * cpr) * V;
    int v[V];
    if (half_on && inverse)
      mf::twiddle_half_run<V>(buf + q * L, i0, hexp[q], L, v);
    else
      mf::load_run<V>(buf + q * L + i0, v);
    mf::store_run<V>(out + base + static_cast<long long>(q) * L + i0, v);
  }
}

template <int V, int P>
int launch_wide(const void* x, void* out, long long B, int C, int L, long long w, int inverse,
                int kmax, int half_on, long long e0, long long step2, int R, void* stream) {
  return static_cast<int>(mf::launch_rows(
      transform_small_wide_kernel<V, P>, B, R, kWideThreads, wide_smem_bytes(C, C / R, L), stream,
      static_cast<const int*>(x), static_cast<int*>(out), C, L, w, inverse, kmax, half_on, e0,
      step2, R));
}

}  // namespace

// x, out: (B, C, L) int32, C = 2^D >= 2; w: the root exponent (z = 2^w);
// kmax: stages per carry group; half_on: 1 for the half-bit twiddle
// (e0 + j*step2)/2 of row j, before the stages (forward: pre_half) or after
// the last carry (inverse: post_half); e0, step2, w are reduced here
// (negative allowed); R: the CTAs a row (1, 2, 4 or 8, C / R >= 2 rows
// each where R > 1; a thread-block cluster where R > 1), the wrapper's
// choice (ops/fused.py whole_cluster).  Rows of at most 64 KB at R 1 take
// the small layout, the rest the wide one; a block or a cluster the card
// cannot hold fails with CUDA's own error.  Runs of 4 digits where
// L % 4 == 0 and x, out are 16-byte aligned, else of one.  Which rows
// launch is the wrapper's rule (ops/fused.py whole_fits).
MF_EXPORT int mf_transform_small(const void* x, void* out, long long B, int C, int L,
                                 long long w, int inverse, int kmax, int half_on, long long e0,
                                 long long step2, int R, void* stream) {
  if (C < 2 || (C & (C - 1)) || L < 1 || kmax < 1 || kmax > mf::kMaxLadderStages || R < 1 ||
      R > mf::kMaxCluster || (R & (R - 1)) || C % R || (R > 1 && C / R < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B * R > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int D = 0;
  while ((1 << D) < C) ++D;
  const long long W2 = 32LL * L, M4 = 64LL * L;
  w = ((w % W2) + W2) % W2;
  e0 = ((e0 % M4) + M4) % M4;
  step2 = ((step2 % M4) + M4) % M4;
  const bool vec = L % 4 == 0 &&
                   (reinterpret_cast<unsigned long long>(x) |
                    reinterpret_cast<unsigned long long>(out)) % 16 == 0;
  if (R > 1 || sizeof(int) * static_cast<size_t>(C) * L > kSmallRowBytes) {
    if (vec) return launch_wide<4, 4>(x, out, B, C, L, w, inverse, kmax, half_on, e0, step2, R,
                                      stream);
    return launch_wide<1, 8>(x, out, B, C, L, w, inverse, kmax, half_on, e0, step2, R, stream);
  }
  if (vec) {
    const int T = mf::group_threads(L / 4, 4, 512);
    if (T == 256)
      return launch<4, 4, 256>(x, out, B, C, D, L, w, inverse, kmax, half_on, e0, step2, stream);
    if (T == 512)
      return launch<4, 4, 512>(x, out, B, C, D, L, w, inverse, kmax, half_on, e0, step2, stream);
  } else {
    const int T = mf::group_threads(L, 8, 1024);
    if (T == 256)
      return launch<1, 8, 256>(x, out, B, C, D, L, w, inverse, kmax, half_on, e0, step2, stream);
    if (T == 1024)
      return launch<1, 8, 1024>(x, out, B, C, D, L, w, inverse, kmax, half_on, e0, step2,
                                stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
