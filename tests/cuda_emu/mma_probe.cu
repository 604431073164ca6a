// One warp's tensor-core step through the helpers of csrc/mma.cuh, for
// tests/test_torch_kernels_emulated.py: D = A B for A (16 x 16) and B
// (16 x 16, row-major, as two n8 tiles) with A loaded by ldmatrix, B by
// ldmatrix.trans, two mma.sync, and the row sums of D reduced over each
// quad of lanes by __shfl_xor_sync. And the TF32 step: D = A B for fp32 A
// (16 x 16) and B (16 x 8) in two mma.sync m16n8k8, either from the 3-pass
// split (split_tf32, mma_tf32x3) or as one pass on the raw fp32 registers;
// and split_tf32's hi part beside cvt.rna.tf32.f32 (to_tf32) of the same
// values. Built with nvcc, the same probes run on the card
// (tests/test_torch_cuda_kernels.py).
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

__global__ void mma_probe_tf32_kernel(const float* a, const float* b, float* d, int split) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  float acc[4] = {};
  for (int k0 = 0; k0 < 16; k0 += 8) {
    const float av[4] = {a[g * 16 + k0 + t], a[(g + 8) * 16 + k0 + t], a[g * 16 + k0 + t + 4],
                         a[(g + 8) * 16 + k0 + t + 4]};
    const float bv[2] = {b[(k0 + t) * 8 + g], b[(k0 + t + 4) * 8 + g]};
    unsigned ahi[4], alo[4], bhi[2], blo[2];
    for (int i = 0; i < 4; ++i) gf::split_tf32(av[i], ahi[i], alo[i]);
    for (int i = 0; i < 2; ++i) gf::split_tf32(bv[i], bhi[i], blo[i]);
    if (split) {
      gf::mma_tf32x3(acc, ahi, alo, bhi, blo);
    } else {
      const unsigned ar[4] = {__float_as_uint(av[0]), __float_as_uint(av[1]),
                              __float_as_uint(av[2]), __float_as_uint(av[3])};
      const unsigned br[2] = {__float_as_uint(bv[0]), __float_as_uint(bv[1])};
      gf::mma_tf32_m16n8k8(acc, ar, br);
    }
  }
  for (int e = 0; e < 4; ++e) d[(g + 8 * (e / 2)) * 8 + 2 * t + e % 2] = acc[e];
}

__global__ void tf32_round_probe_kernel(const float* x, unsigned* split_hi, unsigned* cvt, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    unsigned hi, lo;
    gf::split_tf32(x[i], hi, lo);
    split_hi[i] = hi;
    cvt[i] = gf::to_tf32(x[i]);
  }
}

}  // namespace

extern "C" int tf32_round_probe(const void* x, void* split_hi, void* cvt, int n) {
  GF_LAUNCH(tf32_round_probe_kernel, 1, 256, 0, nullptr, (const float*)x, (unsigned*)split_hi,
            (unsigned*)cvt, n);
  return (int)cudaGetLastError();
}

extern "C" int mma_probe_tf32(const void* a, const void* b, void* d, int split) {
  GF_LAUNCH(mma_probe_tf32_kernel, 1, 32, 0, nullptr, (const float*)a, (const float*)b,
            (float*)d, split);
  return (int)cudaGetLastError();
}

extern "C" int mma_probe(const void* a, const void* b, void* d, void* rowsum) {
  GF_LAUNCH(mma_probe_kernel, 1, 32, 0, nullptr, (const __nv_bfloat16*)a,
            (const __nv_bfloat16*)b, (float*)d, (float*)rowsum);
  return (int)cudaGetLastError();
}
