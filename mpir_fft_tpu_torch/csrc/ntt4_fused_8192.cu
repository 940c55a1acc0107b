// The fused 4-step NTT-CRT kernel at M 8192 (LG2 7), its own source so that
// it compiles beside M 4096's (csrc/ntt4_fused.cu, the entry point and the
// design note).
#include "ntt4_fused.cuh"

namespace mf {

int ntt4_fused_launch_8192(const void* a, const void* b, const void* tables, void* out,
                           long long B, int per_prime, cudaStream_t stream) {
  return launch_fused<7>(a, b, tables, out, B, per_prime, stream);
}

}  // namespace mf
