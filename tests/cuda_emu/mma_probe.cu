// One warp's tensor-core step through the helpers of csrc/mma.cuh, for
// tests/test_torch_kernels_emulated.py: D = A B for A (16 x 16) and B
// (16 x 16, row-major, as two n8 tiles) with A loaded by ldmatrix, B by
// ldmatrix.trans, two mma.sync, and the row sums of D reduced over each
// quad of lanes by __shfl_xor_sync.
#include "mma.cuh"

namespace {

__global__ void mma_probe_kernel(const __nv_bfloat16* a, const __nv_bfloat16* b, float* d,
                                 float* rowsum) {
  __align__(16) __shared__ __nv_bfloat16 As[16][24];
  __align__(16) __shared__ __nv_bfloat16 Bs[16][24];
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  for (int i = lane; i < 256; i += 32) {
    As[i / 16][i % 16] = a[i];
    Bs[i / 16][i % 16] = b[i];
  }
  __syncthreads();
  unsigned af[4], bf[4];
  gf::ldsm_x4(af, &As[lane % 16][(lane / 16) * 8]);
  gf::ldsm_x4_trans(bf, &Bs[(lane / 8) % 2 * 8 + lane % 8][(lane / 16) * 8]);
  float acc[2][4] = {};
  gf::mma_bf16_m16n8k16(acc[0], af, bf);
  gf::mma_bf16_m16n8k16(acc[1], af, bf + 2);
  float sums[2] = {};
  for (int ni = 0; ni < 2; ++ni)
    for (int e = 0; e < 4; ++e) {
      d[(g + 8 * (e / 2)) * 16 + ni * 8 + 2 * t + e % 2] = acc[ni][e];
      sums[e / 2] += acc[ni][e];
    }
  for (int r = 0; r < 2; ++r) {
    sums[r] += gf::shfl_xor(sums[r], 1);
    sums[r] += gf::shfl_xor(sums[r], 2);
    if (t == 0) rowsum[g + 8 * r] = sums[r];
  }
}

}  // namespace

extern "C" int mma_probe(const void* a, const void* b, void* d, void* rowsum) {
  GF_LAUNCH(mma_probe_kernel, 1, 32, 0, nullptr, (const __nv_bfloat16*)a,
            (const __nv_bfloat16*)b, (float*)d, (float*)rowsum);
  return (int)cudaGetLastError();
}
