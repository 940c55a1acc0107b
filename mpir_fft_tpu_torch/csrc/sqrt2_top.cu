// The sqrt2 top layer of the length-4n transforms for odd w, forward and
// inverse, each one pass over the coefficient array.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_sqrt2_top_fwd (fused.py:739-780,
// pallas_call :772) and fused_sqrt2_top_inv (fused.py:783-834, pallas_call
// :826).  Plain versions: ops/fused.py sqrt2_top_fwd_plain and
// sqrt2_top_inv_plain.
//
// Layout: input and output are the whole [N, C, L] array, C = 2h; row j of
// the first half pairs with row j of the second.  q^j = 2^(j w / 2) (half-bit
// exponent e2 = j w mod 4W; q = sqrt2^w is the 4n-th root):
//   fwd:  out[:, j] = carry(a_j + b_j),  out[:, h + j] = carry((a_j - b_j) q^j)
//   inv:  u = oR_j q^-j,  out[:, j] = post(sL_j + u),  out[:, h + j] =
//         post(sL_j - u),  post = a carry, or with a norm shift s the exact
//         canonicalization normmod(v * 2^s) (the drivers' divide by
//         2^lg_conv + normalize tail, s = 2W - lg_conv), so no second launch.
// Reading the halves by row index keeps the stacked operands' [2, C, L]
// array whole: no copy of a non-contiguous half, and the two half
// transforms then run as one transform over [N, 2, h, L].
//
// The twiddle is one sum of shifts: 2^(k+1/2) = 2^(k+3W/4) - 2^(k+W/4) for
// odd e2 = 2k+1 (2^k for even e2), and the norm shift distributes over the
// sum, so every output digit is a signed sum of shift_mod digits of the two
// input rows (limb.shift_mod: rotation, sub-digit shift, sign), e.g. with the
// norm tail sL 2^s +- (oR 2^(k+3W/4+s) - oR 2^(k+W/4+s)).  The values are
// the plain version's; the digits are not: "carry" is two carry passes
// (digits in [-1, 2^16], equal to the plain version's after normmod), and
// the norm tail is exact, so its canonical digits equal the plain
// version's bit for bit.
//
// What bounds it on an H100: device memory -- one read and one write of the
// array, 8 bytes a digit.  Design: a CTA owns a row pair at a time, thread t
// the digits 8t .. 8t+7 of both output rows in registers.  The CTA is
// persistent and double-buffers its row pairs in shared memory (cp.async,
// 16 bytes a copy with an L2 prefetch hint where the rows are aligned): the
// next pair's two rows load while this pair computes.  A staged row is
// followed by its first 16 words again (an "H row"), so the rotated window
// of a thread's digits is contiguous: aligned int4 chunks of shared memory
// and two select rounds, the wrapped words negated by one compare each.
// The thread sums the shifted terms in registers and either runs two carry
// passes on its own digits (the digits below its run come from the same
// windows: no exchange, no barrier) or one pass and the exact carry of both
// rows at once (mf::exact_rows: one shuffle scan, the rows share its two
// barriers, each row's warp totals on a warp of its own).  The outputs go
// out as streaming int4 stores.  From 64 to 640 threads (256 < L <= 5120)
// the kernel is built for two CTAs an SM (48 registers).
#include "normmod_row.cuh"

namespace {

constexpr int kMaxL = 8192;    // the widest row a CTA holds: 8 digits a thread, <= 1024 threads
// the staged rows' layouts: plain rows (runs of 1), H rows (runs of 4)
constexpr int kPlain = 0, kH = 1;
constexpr int kHBack = 16;     // an H row's back halo: x[0 .. 16) after x

__device__ __forceinline__ long long top_exp(long long j, long long w, int L, bool inverse) {
  const long long M4 = 64LL * L;  // 4W
  const long long e = mf::mulmod_small(j, w, M4);
  return inverse ? (M4 - e) % M4 : e;
}

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// 16 bytes, with a prefetch of the 256-byte L2 line around them
__device__ __forceinline__ void cp_async16_l2(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// Ints of shared memory one row of a staged pair takes.
__host__ __device__ __forceinline__ int row_ints(int LAY, int L) {
  return LAY == kH ? L + kHBack : L;
}

// Rows j and h + j of row pair p into the pair buffer buf, without waiting
// (cp.async).  kH: x and its first kHBack words again after it, so that a
// window that wraps is contiguous.
template <int LAY>
__device__ __forceinline__ void stage_pair(const int* x, long long p, long long h, int L,
                                           int* buf) {
  const long long n = p / h, j = p - n * h;
  const int* ra = x + (n * 2 * h + j) * L;
  const int* rb = ra + h * L;
  const int rs = row_ints(LAY, L);
  if constexpr (LAY == kH) {
    const int q = (L + kHBack) / 4;  // chunks a row, the halo's last
    for (int c = threadIdx.x; c < 2 * q; c += blockDim.x) {
      const int r = c >= q, c1 = c - r * q;
      cp_async16_l2(buf + r * rs + 4 * c1, (r ? rb : ra) + (4 * c1 < L ? 4 * c1 : 4 * c1 - L));
    }
  } else {
    for (int i = threadIdx.x; i < 2 * L; i += blockDim.x)
      cp_async4(buf + i, i >= L ? rb + (i - L) : ra + i);
  }
}

// The N+1 rotated words of destinations j0-1 .. j0+N-1 (j0 >= -2) of
// rot(x, kd), x an H row (stage_pair): consecutive words mod L from
// (j0 - 1 - kd) mod L, read as aligned int4 chunks (the halo makes a
// wrapping window contiguous) and picked by two select rounds; words of
// destinations below kd wrapped, so negated (for a destination e < 0, the
// digit e + L's rule: the words below digit 0 of the thread that holds it).
template <int N>
__device__ __forceinline__ void h_words(const int* X, int j0, int kd, int L, int (&v)[N + 1]) {
  constexpr int C = (N + 7) / 4;
  const int e0 = j0 - 1;            // the destination of word 0
  int idx = e0 - kd;                // the word of destination e is +-X[(e - kd) mod L]
  idx += idx < 0 ? L : 0;
  idx += idx < 0 ? L : 0;
  const int c = idx & ~3, o = idx & 3;
  int w[4 * C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    if (4 * k >= o + N + 1) {       // the window ends before this chunk (o: uniform)
      w[4 * k] = w[4 * k + 1] = w[4 * k + 2] = w[4 * k + 3] = 0;
      continue;
    }
    const int4 a = *reinterpret_cast<const int4*>(X + c + 4 * k);
    w[4 * k] = a.x;
    w[4 * k + 1] = a.y;
    w[4 * k + 2] = a.z;
    w[4 * k + 3] = a.w;
  }
  int y[N + 3];
#pragma unroll
  for (int t = 0; t < N + 3; ++t) y[t] = (o & 1) ? w[t + 1] : w[t];
#pragma unroll
  for (int t = 0; t < N + 1; ++t) v[t] = (o & 2) ? y[t + 2] : y[t];
  const int thr = kd - e0;
#pragma unroll
  for (int t = 0; t < N + 1; ++t)
    if (t < thr) v[t] = -v[t];
  if (e0 < 0) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
      if (t < -e0 && t >= thr - L && t < thr) v[t] = -v[t];
  }
}

// The sub-digit shift by b of the rotated words v (destinations j0-1 ..
// j0+N-1) into digits j0 .. j0+N-1: digit i takes the low 16-b bits of
// word i shifted up by b and the high bits of word i-1, and digit 0 (d[N -
// D] of the thread at i0 == 0) the high bits of digit L-1's word negated.
template <int D, int N>
__device__ __forceinline__ void h_split(const int (&v)[N + 1], int b, int i0, int (&d)[N]) {
  constexpr int B = N - D;
  const int sh = mf::DIGIT_BITS - b;
  const int lo = (1 << sh) - 1;
#pragma unroll
  for (int t = 0; t < N; ++t) d[t] = mf::shl(v[t + 1] & lo, b) + (v[t] >> sh);
  if (i0 == 0) d[B] -= 2 * (v[B] >> sh);
}

// rotation kd, sub-digit shift b and sign of a shift exponent s in [0, 2W)
struct Shift {
  int kd, b, sgn;
};
__device__ __forceinline__ Shift decompose(int s, int L) {
  const int W = mf::DIGIT_BITS * L;
  const bool neg = s >= W;
  const int r = neg ? s - W : s;
  return {r >> 4, r & 15, neg ? -1 : 1};
}

// The two output rows' digits j0 .. j0+N-1 (j0 = i0 - (N - D)) before their
// carries, from the pair's rows A (first half) and B (second half) in
// shared memory (H rows, else plain rows): va, vb.  e2: the
// twiddle's half-bit exponent; s0: the norm shift (inverse; 0 without the
// tail).  The twiddle's shifts: k = e2/2 (even e2), or k + 3W/4 (+) and
// k + W/4 (-) for odd e2.
template <int LAY, int D, int N, bool INV>
__device__ __forceinline__ void pair_terms(const int* A, const int* B, int i0, int L, int e2,
                                           int s0, int (&va)[N], int (&vb)[N]) {
  const int W2 = 32 * L;
  const int k = e2 >> 1;
  const bool odd = e2 & 1;
  const int j0 = i0 - (N - D);
  const int kt = odd ? k + 12 * L : k;
  const int kl = k + 4 * L;
  int P[N], Q[N];
  if constexpr (LAY != kPlain) {
    int wt[N + 1], wx[N + 1];
    if constexpr (INV) {
      // S = sL 2^s0, T = oR 2^(e2/2 + s0); va = S + T, vb = S - T.  The two
      // shifts of an odd e2 differ by W/2, a whole number of digits, so
      // their words combine before one sub-digit shift (a split's value is
      // linear in its words).
      const Shift ss = decompose(s0, L);
      h_words<N>(A, j0, ss.kd, L, wx);
      h_split<D, N>(wx, ss.b, i0, va);
      const Shift s1 = decompose((kt + s0) % W2, L);
      h_words<N>(B, j0, s1.kd, L, wt);
#pragma unroll
      for (int t = 0; t <= N; ++t) wt[t] *= s1.sgn;
      if (odd) {
        const Shift s2 = decompose((kl + s0) % W2, L);
        h_words<N>(B, j0, s2.kd, L, wx);
#pragma unroll
        for (int t = 0; t <= N; ++t) wt[t] -= s2.sgn * wx[t];
      }
      h_split<D, N>(wt, s1.b, i0, P);
#pragma unroll
      for (int t = 0; t < N; ++t) {
        const int S = ss.sgn * va[t];
        va[t] = S + P[t];
        vb[t] = S - P[t];
      }
    } else {
      // va = a + b, vb = (a - b) 2^(e2/2)
      h_words<N>(A, j0, 0, L, wt);
      h_words<N>(B, j0, 0, L, wx);
#pragma unroll
      for (int t = 0; t <= N; ++t) wt[t] += wx[t];
      h_split<D, N>(wt, 0, i0, va);
      const Shift s1 = decompose(kt % W2, L);
      h_words<N>(A, j0, s1.kd, L, wt);
      h_words<N>(B, j0, s1.kd, L, wx);
#pragma unroll
      for (int t = 0; t <= N; ++t) wt[t] -= wx[t];
      h_split<D, N>(wt, s1.b, i0, vb);
#pragma unroll
      for (int t = 0; t < N; ++t) vb[t] *= s1.sgn;
      if (odd) {
        const Shift s2 = decompose(kl % W2, L);
        h_words<N>(A, j0, s2.kd, L, wt);
        h_words<N>(B, j0, s2.kd, L, wx);
#pragma unroll
        for (int t = 0; t <= N; ++t) wt[t] -= wx[t];
        h_split<D, N>(wt, s2.b, i0, Q);
#pragma unroll
        for (int t = 0; t < N; ++t) vb[t] -= s2.sgn * Q[t];
      }
    }
  } else {
    // plain rows, one digit a run: shift_mod digit by digit (mf::shifted_digits)
    if constexpr (INV) {
      mf::shifted_digits<1, N>(A, j0, s0, L, va);
      mf::shifted_digits<1, N>(B, j0, (kt + s0) % W2, L, P);
      if (odd) {
        mf::shifted_digits<1, N>(B, j0, (kl + s0) % W2, L, Q);
#pragma unroll
        for (int t = 0; t < N; ++t) P[t] -= Q[t];
      }
#pragma unroll
      for (int t = 0; t < N; ++t) {
        vb[t] = va[t] - P[t];
        va[t] += P[t];
      }
    } else {
      mf::shifted_digits<1, N>(A, j0, 0, L, va);
      mf::shifted_digits<1, N>(B, j0, 0, L, P);
#pragma unroll
      for (int t = 0; t < N; ++t) va[t] += P[t];
      mf::shifted_digits<1, N>(A, j0, kt % W2, L, vb);
      mf::shifted_digits<1, N>(B, j0, kt % W2, L, P);
#pragma unroll
      for (int t = 0; t < N; ++t) vb[t] -= P[t];
      if (odd) {
        mf::shifted_digits<1, N>(A, j0, kl % W2, L, P);
        mf::shifted_digits<1, N>(B, j0, kl % W2, L, Q);
#pragma unroll
        for (int t = 0; t < N; ++t) vb[t] -= P[t] - Q[t];
      }
    }
  }
}

// One carry pass over digits i0 .. i0+D-1 of w (its first N - D words the
// digits below i0): two passes where N == D + 2, the first pass's digit
// i0-1 from the two below it; one where N == D + 1.
template <int D, int N>
__device__ __forceinline__ void carried(const int (&w)[N], int i0, int L, int (&v)[D]) {
#pragma unroll
  for (int t = 0; t < D; ++t) v[t] = w[t + N - D];
  if constexpr (N == D + 2) {
    const int im1 = i0 == 0 ? L - 1 : i0 - 1;
    const int c1 = w[0] >> mf::DIGIT_BITS;
    const int p1 = (w[1] & mf::DIGIT_MASK) + (im1 == 0 ? -c1 : c1);
    mf::carry_digits(v, w[1], i0);
    mf::carry_digits(v, p1, i0);
  } else {
    mf::carry_digits(v, w[0], i0);
  }
}

// The kernels' body: INV the inverse merge, else the forward layer; EXACT
// (inverse only) the norm tail with shift s.  blockDim.x * V * R >= L, a
// multiple of 32; two pair buffers.
template <int LAY, int R, bool INV, bool EXACT>
__device__ __forceinline__ void top_pairs(const int* __restrict__ x, int* __restrict__ out,
                                          long long npairs, long long h, int L, long long w,
                                          int s) {
  constexpr int V = LAY == kPlain ? 1 : 4;
  constexpr int D = V * R;
  constexpr int N = EXACT ? D + 1 : D + 2;
  extern __shared__ int4 smem4[];
  int* const sm = reinterpret_cast<int*>(smem4);
  const int rs = row_ints(LAY, L);
  const int i0 = threadIdx.x * D;
  const bool on = i0 < L;
  long long p = blockIdx.x;
  if (p < npairs) stage_pair<LAY>(x, p, h, L, sm);
  for (int buf = 0; p < npairs; p += gridDim.x, buf ^= 1) {
    const int* A = sm + buf * 2 * rs;
    mf::cp_async_wait_all();
    __syncthreads();          // pair p staged; every thread is done with the other buffer
    if (p + gridDim.x < npairs) stage_pair<LAY>(x, p + gridDim.x, h, L, sm + (buf ^ 1) * 2 * rs);
    const long long n = p / h, j = p - n * h;
    int* const oa = out + (n * 2 * h + j) * L;
    int* const ob = oa + h * L;
    int va[N], vb[N];
    if (on) {
      pair_terms<LAY, D, N, INV>(A, A + rs, i0, L, static_cast<int>(top_exp(j, w, L, INV)),
                                 EXACT ? s : 0, va, vb);
    } else {
#pragma unroll
      for (int t = 0; t < N; ++t) va[t] = vb[t] = 0;
    }
    int v[2][D];
    carried<D, N>(va, i0, L, v[0]);
    carried<D, N>(vb, i0, L, v[1]);
    if constexpr (EXACT) {
      int* const o[2] = {oa, ob};
      mf::exact_rows<V, R, 2, true>(v, i0, L, o);
    } else if (on) {
      mf::store_runs<V, R, true>(oa, i0, L, v[0]);
      mf::store_runs<V, R, true>(ob, i0, L, v[1]);
    }
  }
}

// MINB 2: at most 640 threads, two CTAs an SM
template <int LAY, int R, int MINB>
__global__ void __launch_bounds__(MINB == 2 ? 640 : 1024, MINB)
sqrt2_top_fwd_kernel(const int* __restrict__ x, int* __restrict__ out, long long npairs,
                     long long h, int L, long long w, int s) {
  top_pairs<LAY, R, false, false>(x, out, npairs, h, L, w, s);
}

template <int LAY, int R, int MINB, bool EXACT>
__global__ void __launch_bounds__(MINB == 2 ? 640 : 1024, MINB)
sqrt2_top_inv_kernel(const int* __restrict__ x, int* __restrict__ out, long long npairs,
                     long long h, int L, long long w, int s) {
  top_pairs<LAY, R, true, EXACT>(x, out, npairs, h, L, w, s);
}

// A persistent grid: as many CTAs as the card holds at once, each looping
// over the row pairs.
template <int LAY, int R, int MINB, bool INV, bool EXACT>
int launch_r(const void* x, void* out, long long npairs, long long h, int L, long long w, int s,
             cudaStream_t stream) {
  constexpr int V = LAY == kPlain ? 1 : 4;
  const auto kernel =
      INV ? sqrt2_top_inv_kernel<LAY, R, MINB, EXACT> : sqrt2_top_fwd_kernel<LAY, R, MINB>;
  const int threads = ((L + V * R - 1) / (V * R) + 31) / 32 * 32;
  if (threads > (MINB == 2 ? 640 : 1024)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4ull * row_ints(LAY, L) * sizeof(int);
  cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long grid = npairs < resident ? npairs : resident;
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      static_cast<const int*>(x), static_cast<int*>(out), npairs, h, L, w, s);
  return static_cast<int>(cudaGetLastError());
}

// the layout: runs of 4 digits on H rows where L % 4 == 0, L >= 16 and the
// rows are 16-byte aligned (mf::run_width), else runs of 1 on plain rows;
// 8 digits a thread
template <bool INV, bool EXACT>
int launch(const void* x, void* out, long long npairs, long long h, int L, long long w, int s,
           cudaStream_t stream) {
  if (mf::run_width(L, x, out) != 4 || L < 16)
    return launch_r<kPlain, 8, 1, INV, EXACT>(x, out, npairs, h, L, w, s, stream);
  // the 48-register build where it lets more CTAs reside than 64 registers
  // do: from 64 threads (below, the 32-CTA limit binds) to 640
  return L > 8 * 32 && L <= 8 * 640
             ? launch_r<kH, 2, 2, INV, EXACT>(x, out, npairs, h, L, w, s, stream)
             : launch_r<kH, 2, 1, INV, EXACT>(x, out, npairs, h, L, w, s, stream);
}

cudaError_t launch_check(long long N, long long h, int L, long long* npairs) {
  if (L < 1 || L > kMaxL || h < 1 || N < 0) return cudaErrorInvalidValue;
  *npairs = N * h;
  return cudaSuccess;
}

}  // namespace

// x, out: (N, 2h, L) int32, L <= 8192; w: the transform's odd root exponent.
MF_EXPORT int mf_sqrt2_top_fwd(const void* x, void* out, long long N, long long h, int L,
                               long long w, void* stream) {
  long long npairs = 0;
  const cudaError_t err = launch_check(N, h, L, &npairs);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (npairs == 0) return 0;
  return launch<false, false>(x, out, npairs, h, L, w, 0, static_cast<cudaStream_t>(stream));
}

// s: the norm tail's shift exponent in [0, 2W), or -1 for a carry only.
MF_EXPORT int mf_sqrt2_top_inv(const void* x, void* out, long long N, long long h, int L,
                               long long w, int s, void* stream) {
  long long npairs = 0;
  const cudaError_t err = launch_check(N, h, L, &npairs);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long W = 16LL * L;
  if (s < -1 || s >= 2 * W) return static_cast<int>(cudaErrorInvalidValue);
  if (npairs == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s < 0 ? launch<true, false>(x, out, npairs, h, L, w, s, st)
               : launch<true, true>(x, out, npairs, h, L, w, s, st);
}
