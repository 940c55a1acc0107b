// Half-bit twiddle of ring-element rows: out[r] = x[r] * 2^(e2_r / 2) mod
// 2^(16L)+1 with the affine exponent e2_r = (e0 + (r mod h) * step) mod 4W.
//
// Replaces: mpir_fft_tpu/ops/fused.py fused_twiddle_half (fused.py:533-572,
// pallas_call :562), whose body is _twiddle_half_rows (:714-736).  Plain
// version: ops/fused.py twiddle_half_rows_plain, the same integer sequence,
// so the digits agree exactly.  It runs where the weights cannot ride a
// transform kernel: the inverse unweighting of a negacyclic transform on the
// ladder route (ops/transforms.py post_half; mulmod_int's rings), the MFA
// tail reconstruction (ops/sqrt2.py) and a length-1 transform's pre_half.
// The whole-row transform (csrc/transform_small.cu) and the ladder's pre_half
// run the same row body inside their own kernels.
//
// Per row: even e2 is a plain shift_mod by k = e2/2; odd e2 is the sqrt2
// shift carry_pass(hi - lo), 2^(k+1/2) = 2^(k+3W/4) - 2^(k+W/4)
// (mf::twiddle_half_run, ladder_group.cuh).
//
// What bounds it on an H100: device memory -- one read and one write of the
// row.  Design: a thread computes a run of V = 4 digits (L % 4 == 0, aligned
// tensors; else V = 1) straight from the row in device memory, its rotated
// window as two aligned int4 loads that the row's other runs share through
// L1, and stores it as one 16-byte vector; no shared-memory row and no
// barrier per phase.  A CTA of 256 threads takes R = 1024 / (L/V) whole rows
// where a row has at most 1024 runs (85 rows of L 48, one of L 4096), their
// exponents decomposed once per row into a shared table (one barrier per
// CTA); a longer row spreads over 1024-run chunks, one CTA each, every
// thread decomposing the row's exponent once.
#include "ladder_group.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRuns = 4 * kThreads;           // runs per CTA

template <int V>
__global__ void __launch_bounds__(kThreads)
twiddle_half_kernel(const int* __restrict__ x, int* __restrict__ out, long long B, int L,
                    long long h, long long e0, long long step, int R, long long Q) {
  __shared__ int e2s[kRuns];
  const int cpr = L / V;                       // runs per row
  long long row0;
  int first, nruns, e2own = 0;
  if (R > 1) {                                 // R whole rows
    row0 = static_cast<long long>(blockIdx.x) * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R), B - row0));
    nruns = rows * cpr;
    first = 0;
    for (int t = threadIdx.x; t < rows; t += kThreads)
      e2s[t] = mf::half_exp((row0 + t) % h, e0, step, L);
    __syncthreads();
  } else {                                     // chunk c of one row
    row0 = blockIdx.x / Q;
    first = static_cast<int>(blockIdx.x % Q) * kRuns;
    nruns = min(kRuns, cpr - first);
    e2own = mf::half_exp(row0 % h, e0, step, L);
  }
  const int lg = mf::div_lg(cpr);
  const unsigned mg = mf::div_magic(cpr);
  for (int g = threadIdx.x; g < nruns; g += kThreads) {
    const int rr = R > 1 ? mf::div_small(g, lg, mg) : 0;
    const int i0 = (first + g - rr * cpr) * V;
    const long long off = (row0 + rr) * L;
    int v[V];
    mf::twiddle_half_run<V>(x + off, i0, R > 1 ? e2s[rr] : e2own, L, v);
    mf::store_run<V>(out + off + i0, v);
  }
}

template <int V>
int launch(const void* x, void* out, long long B, int L, long long h, long long e0,
           long long step, void* stream) {
  const int cpr = L / V;
  const int R = cpr <= kRuns ? kRuns / cpr : 1;
  const long long Q = R > 1 ? 1 : (cpr + kRuns - 1) / kRuns;
  const long long grid = R > 1 ? (B + R - 1) / R : B * Q;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  twiddle_half_kernel<V><<<static_cast<unsigned>(grid), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), B, L, h, e0, step, R, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (B, L) int32; row r takes j = r mod h.  e0 and step are reduced
// mod 4W here (step may be negative).
MF_EXPORT int mf_twiddle_half(const void* x, void* out, long long B, int L, long long h,
                              long long e0, long long step, void* stream) {
  if (L < 1 || h < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const long long M4 = 64LL * L;
  e0 = ((e0 % M4) + M4) % M4;
  step = ((step % M4) + M4) % M4;
  const bool vec = L % 4 == 0 &&
                   (reinterpret_cast<unsigned long long>(x) |
                    reinterpret_cast<unsigned long long>(out)) % 16 == 0;
  return vec ? launch<4>(x, out, B, L, h, e0, step, stream)
             : launch<1>(x, out, B, L, h, e0, step, stream);
}
