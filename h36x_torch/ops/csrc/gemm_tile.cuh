// The FP32 GEMM tile of the temporal forward (temporal.cu) and of both
// backward kernels (temporal_bwd.cu, regressor_bwd.cu): a block of 128
// threads owns a BM x BN output tile and walks the reduction BK at a time
// through shared memory; each thread keeps a TM x TN micro-tile of
// accumulators on the FP32 FMA pipes. Loaders differ per kernel and live
// there; this header holds the tile geometry and the multiply.

#pragma once

namespace h36x {

constexpr int BM = 32, BN = 64, BK = 32, TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 128
constexpr int APAD = 4, BPAD = 4;  // keep rows 16-byte aligned, spread banks
constexpr int A_ELEMS = BM * BK / kThreads;  // A-tile elements a thread loads
constexpr int B_ELEMS = BK * BN / kThreads;  // B-tile elements a thread loads
static_assert(TM == 4 && TN == 4, "one float4 per operand and k");
static_assert(kThreads % BK == 0 && kThreads % BN == 0 && kThreads % BM == 0,
              "load layouts");

struct Tile {
  float a[BK][BM + APAD];  // A stored k-major: a[k][m]
  float b[BK][BN + BPAD];  // b[k][n]
};

__device__ __forceinline__ void zero_acc(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k a[k][ty*TM + i] * b[k][tx*TN + j]
__device__ __forceinline__ void tile_fma(const Tile& s, float (&acc)[TM][TN],
                                         int tx, int ty) {
#pragma unroll
  for (int kl = 0; kl < BK; ++kl) {
    const float4 va = *reinterpret_cast<const float4*>(&s.a[kl][ty * TM]);
    const float4 vb = *reinterpret_cast<const float4*>(&s.b[kl][tx * TN]);
    const float a[TM] = {va.x, va.y, va.z, va.w};
    const float b[TN] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

}  // namespace h36x
