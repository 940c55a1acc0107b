/* The host oracle and the CPU baseline of the port: GMP's assembly
 * multiplier (mpn_mul) on little-endian byte buffers, and its timing
 * harness.  The port's own copy of mpir_fft_tpu/native/marshal.c's
 * gmp_mul_bytes and of mpir_fft_tpu/native/gmp_baseline.c, as one shared
 * library bound with ctypes (mpir_fft_tpu_torch/native/__init__.py).
 *
 * Images often ship libgmp.so.10 without headers; the mpn ABI is stable,
 * so the one entry point needed is declared here and linked directly:
 *
 *   cc -O2 -shared -fPIC -o libmf_gmp.so gmp.c -l:libgmp.so.10
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

typedef unsigned long mf_limb_t; /* 64-bit on x86-64 / aarch64 */

/* GMP's public mpn entry points use the __gmpn_ prefix at the ABI level. */
extern mf_limb_t __gmpn_mul(mf_limb_t *rp, const mf_limb_t *u, long un,
                            const mf_limb_t *v, long vn);

/* Exact product of two little-endian magnitude byte buffers into out
 * (abytes + bbytes bytes).  Returns 0, or -1 if an allocation failed. */
int mf_gmp_mul_bytes(const uint8_t *a, size_t abytes, const uint8_t *b,
                     size_t bbytes, uint8_t *out) {
  size_t al = (abytes + 7) / 8, bl = (bbytes + 7) / 8;
  mf_limb_t *la = (mf_limb_t *)calloc(al ? al : 1, 8);
  mf_limb_t *lb = (mf_limb_t *)calloc(bl ? bl : 1, 8);
  mf_limb_t *lr = (mf_limb_t *)calloc(al + bl ? al + bl : 1, 8);
  if (!la || !lb || !lr) {
    free(la); free(lb); free(lr);
    return -1;
  }
  memcpy(la, a, abytes);
  memcpy(lb, b, bbytes);
  if (al == 0 || bl == 0)
    ; /* a zero operand: the product is the zeroed buffer */
  else if (al >= bl)
    __gmpn_mul(lr, la, (long)al, lb, (long)bl);
  else
    __gmpn_mul(lr, lb, (long)bl, la, (long)al);
  memcpy(out, lr, abytes + bbytes);
  free(la); free(lb); free(lr);
  return 0;
}

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

/* The baseline: the best of reps wall times of one mpn_mul of two
 * bits-bit operands (top bits set, from srand(12345)), after a warm-up.
 * Writes the limb count to *limbs; returns the seconds, or -1 if an
 * allocation failed. */
double mf_gmp_baseline(long bits, int reps, long *limbs) {
  long n = (bits + 63) / 64;
  mf_limb_t *a = malloc((size_t)n * sizeof *a);
  mf_limb_t *b = malloc((size_t)n * sizeof *b);
  mf_limb_t *r = malloc((size_t)(2 * n) * sizeof *r);
  if (!a || !b || !r) {
    free(a); free(b); free(r);
    return -1.0;
  }
  srand(12345);
  for (long i = 0; i < n; i++) {
    a[i] = ((mf_limb_t)rand() << 33) ^ ((mf_limb_t)rand() << 10) ^ (mf_limb_t)rand();
    b[i] = ((mf_limb_t)rand() << 33) ^ ((mf_limb_t)rand() << 10) ^ (mf_limb_t)rand();
  }
  a[n - 1] |= (mf_limb_t)1 << 63;
  b[n - 1] |= (mf_limb_t)1 << 63;

  __gmpn_mul(r, a, n, b, n); /* warm-up */
  double best = 1e30;
  for (int i = 0; i < reps; i++) {
    double t0 = now_s();
    __gmpn_mul(r, a, n, b, n);
    double dt = now_s() - t0;
    if (dt < best) best = dt;
  }
  volatile mf_limb_t sink = r[0] ^ r[2 * n - 1]; /* keep r live */
  (void)sink;
  *limbs = n;
  free(a); free(b); free(r);
  return best;
}
