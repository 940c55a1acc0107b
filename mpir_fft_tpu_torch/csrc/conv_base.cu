// Schoolbook pointwise product mod 2^(16L)+1.
//
// Replaces: mpir_fft_tpu/ops/pointwise_fused.py mulmod_base_fused /
// _conv_kernel (pointwise_fused.py:77 and :48).  Plain version:
// ops/pointwise.py conv_base_plain (the chunk convolution); the two agree
// after normmod.
//
// Input (B, L) int32 redundant digits a, b; output (B, L) bounded redundant
// digits of a*b mod 2^(16L)+1.  Per digit position a = alo + 2^8 ahi, and
//   c = conv(alo,blo) + 2^8 (conv(alo,bhi) + conv(ahi,blo)) + 2^16 conv(ahi,bhi)
// negacyclic over digit positions (2^(16L) == -1), then
//   d = acc_ll + 2^8 (acc_m mod 2^8) + nega_roll((acc_m >> 8) + acc_hh)
// and one carry_pass -- the formulas of the TPU kernel.  Accumulator bound
// (pointwise_fused.py:19-22): with |digit| <= ~2^17, |hi plane| <= 2^9, so a
// plane product is < 2^18 and a sum of L <= 2048 of them < 2^29: exact in
// int32 for every ring the base serves (2L <= 4096).
//
// What bounds it on an H100: integer issue, O(L^2) multiply-adds per row
// (4 L^2 IMADs; a memory pass is only 12 bytes per digit).  Design: one CTA
// per row; both operands' byte planes sit in shared memory, the b planes
// stored as [-b, b] so every negacyclic shift is a plain offset (no modulo
// or branch in the inner loop); each thread owns output digits and sweeps
// i over the a planes, which all lanes read at the same address (a
// broadcast).  No tensor cores and no register blocking yet.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
conv_base_kernel(const int* __restrict__ a, const int* __restrict__ b,
                 int* __restrict__ out, int L) {
  extern __shared__ int sm[];
  int* alo = sm;             // L
  int* ahi = alo + L;        // L
  int* blo = ahi + L;        // 2L: [-blo, blo]
  int* bhi = blo + 2 * L;    // 2L: [-bhi, bhi]
  int* u = bhi + 2 * L;      // L: (acc_m >> 8) + acc_hh
  int* d = u + L;            // L: acc_ll + 2^8 (acc_m mod 2^8)
  const long long row = blockIdx.x;
  const int* ar = a + row * L;
  const int* br = b + row * L;

  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const int av = ar[i], bv = br[i];
    const int al = av & 0xFF, bl = bv & 0xFF;
    const int bh = (bv - bl) >> 8;
    alo[i] = al;
    ahi[i] = (av - al) >> 8;
    blo[L + i] = bl;
    blo[i] = -bl;
    bhi[L + i] = bh;
    bhi[i] = -bh;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    int ll = 0, mm = 0, hh = 0;
    const int* bl = blo + L + j;     // bl[-i] = b_lo[j - i], negated on wrap
    const int* bh = bhi + L + j;
    for (int i = 0; i < L; ++i) {
      const int al = alo[i], ah = ahi[i];
      const int vl = bl[-i], vh = bh[-i];
      ll += al * vl;
      mm += al * vh + ah * vl;
      hh += ah * vh;
    }
    const int m_lo = mm & 0xFF;
    d[j] = ll + (m_lo << 8);
    u[j] = ((mm - m_lo) >> 8) + hh;
  }
  __syncthreads();

  int* e = alo;                      // free now: d + nega_roll(u)
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    e[j] = d[j] + (j == 0 ? -u[L - 1] : u[j - 1]);
  __syncthreads();

  int* outr = out + row * L;
  for (int j = threadIdx.x; j < L; j += blockDim.x) outr[j] = mf::carry_digit(e, j, L);
}

}  // namespace

MF_EXPORT int mf_conv_base(const void* a, const void* b, void* out, long long B, int L,
                           void* stream) {
  if (L < 1 || 2 * L > 4096) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  if (B > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = 8ull * L * sizeof(int);
  cudaError_t err = mf::set_smem(reinterpret_cast<const void*>(conv_base_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_base_kernel<<<static_cast<unsigned>(B), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b), static_cast<int*>(out), L);
  return static_cast<int>(cudaGetLastError());
}
