// Fused iterative-error-feedback joint regressor, FP32, sm_90a, one launch.
//
// Replaces the Pallas TPU kernel h36x/ops/pallas_regressor.py::_kernel
// (reached through _fused_forward / fused_joint_regressor):
//
//   y = 0;  pw1 = phi @ W1[:D]              (once)
//   repeat iters times:
//     h1 = relu(pw1 + y @ W1[D:D+P] + b1)
//     h2 = relu(h1 @ W2 + b2)
//     y  = y + h2 @ W3 + b3
//
// The concat [phi; y] @ W1 is done by splitting W1's rows, as on the TPU; y
// lives in a P_PAD = 64 column layout and the output is (N, 64), of which
// the caller keeps the first P = out_dim columns.
//
// What bounds it on the H100: operations. At the serving shape (N = B*T =
// 640, D = H = 1024, P = 51, 3 rounds) it does about 5.8 GFLOP over about
// 12 MB of inputs and outputs (the f32 weights are 8.8 MB of that).
//
// Design: one block per tile of RT = 8 rows keeps pw1, h1, h2 and y for
// its rows in shared memory across all rounds (3 x 32 KB + 10 KB at
// H = 1024, so the launch raises the dynamic shared-memory limit first), so
// no activation goes to device memory: one read of phi, one write of y. The
// weights do not fit on chip; every block streams them from global memory,
// where they stay in the 50 MB L2 cache, with the weight loops unrolled by 4
// to keep several L2 loads in flight. Each thread owns 4 output columns of
// a 1024-column chunk for all 8 rows (32 accumulators); the A operand is
// read from shared memory as a broadcast, stored column-major ([k][r]) so
// one k is two float4 loads. The 64-column y update splits the H reduction
// over four thread groups and sums their partials in shared memory. At
// N = 640 this is 80 blocks on 132 SMs: the card is under-filled, the first
// known limit of this kernel (fewer rows a block would fill it, but every
// block re-reads all weights from L2).

#include <cuda_runtime.h>

namespace {

constexpr int RT = 8;             // rows per block
constexpr int NT = 256;           // threads per block
constexpr int CPT = 4;            // columns per thread per chunk
constexpr int CH = NT * CPT;      // columns per chunk
constexpr int KC = 64;            // depth of one staged slice of phi
constexpr int P_PAD = 64;         // padded width of the iterate y
constexpr int NQ = NT / P_PAD;    // thread groups splitting the W3 reduction

__device__ __forceinline__ void load_col(const float* __restrict__ p, float a[RT]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < RT / 4; ++i) {
    const float4 v = q[i];
    a[4 * i] = v.x; a[4 * i + 1] = v.y; a[4 * i + 2] = v.z; a[4 * i + 3] = v.w;
  }
}

__global__ void __launch_bounds__(NT)
regressor_kernel(const float* __restrict__ phi, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ w3,
                 const float* __restrict__ b3, float* __restrict__ out,
                 int N, int D, int H, int P, int iters) {
  extern __shared__ float4 smem4[];
  float* pw1T = reinterpret_cast<float*>(smem4);  // [H][RT]
  float* h1T = pw1T + (size_t)H * RT;             // [H][RT]
  float* h2T = h1T + (size_t)H * RT;              // [H][RT]
  float* yT = h2T + (size_t)H * RT;               // [P_PAD][RT]
  float* scratch = yT + P_PAD * RT;               // phi slices, then W3 partials

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * RT;
  const int nrows = min(RT, N - r0);

  for (int i = tid; i < P_PAD * RT; i += NT) yT[i] = 0.f;

  // pw1 = phi @ W1[:D], phi staged through shared memory KC columns at a time
  for (int c0 = 0; c0 < H; c0 += CH) {
    float acc[RT][CPT];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += KC) {
      __syncthreads();
      for (int i = tid; i < RT * KC; i += NT) {
        const int r = i / KC, kl = i - r * KC;
        scratch[kl * RT + r] = (r < nrows && k0 + kl < D)
                                   ? phi[(size_t)(r0 + r) * D + k0 + kl] : 0.f;
      }
      __syncthreads();
      const int kmax = min(KC, D - k0);
#pragma unroll 4
      for (int kl = 0; kl < kmax; ++kl) {
        float a[RT];
        load_col(scratch + kl * RT, a);
        const float* wrow = w1 + (size_t)(k0 + kl) * H;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = c0 + j * NT + tid;
          const float wv = col < H ? wrow[col] : 0.f;
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r][j] = fmaf(a[r], wv, acc[r][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = c0 + j * NT + tid;
      if (col < H) {
#pragma unroll
        for (int r = 0; r < RT; ++r) pw1T[(size_t)col * RT + r] = acc[r][j];
      }
    }
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // h1 = relu(pw1 + y @ W1[D:D+P] + b1); each thread reads only its own pw1
    for (int col = tid; col < H; col += NT) {
      float acc[RT];
      load_col(pw1T + (size_t)col * RT, acc);
      const float bv = b1[col];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] += bv;
#pragma unroll 4
      for (int k = 0; k < P; ++k) {
        float a[RT];
        load_col(yT + k * RT, a);
        const float wv = w1[(size_t)(D + k) * H + col];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = fmaf(a[r], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) h1T[(size_t)col * RT + r] = fmaxf(acc[r], 0.f);
    }
    __syncthreads();

    // h2 = relu(h1 @ W2 + b2)
    for (int c0 = 0; c0 < H; c0 += CH) {
      float acc[RT][CPT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[r][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        float a[RT];
        load_col(h1T + (size_t)k * RT, a);
        const float* wrow = w2 + (size_t)k * H;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = c0 + j * NT + tid;
          const float wv = col < H ? wrow[col] : 0.f;
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r][j] = fmaf(a[r], wv, acc[r][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = c0 + j * NT + tid;
        if (col < H) {
          const float bv = b2[col];
#pragma unroll
          for (int r = 0; r < RT; ++r)
            h2T[(size_t)col * RT + r] = fmaxf(acc[r][j] + bv, 0.f);
        }
      }
    }
    __syncthreads();

    // y += h2 @ W3 + b3: thread group q sums k = q, q + NQ, ... into scratch
    {
      const int c = tid % P_PAD, q = tid / P_PAD;
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = 0.f;
      if (c < P) {
#pragma unroll 4
        for (int k = q; k < H; k += NQ) {
          float a[RT];
          load_col(h2T + (size_t)k * RT, a);
          const float wv = w3[(size_t)k * P + c];
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(a[r], wv, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) scratch[(q * P_PAD + c) * RT + r] = acc[r];
    }
    __syncthreads();
    for (int i = tid; i < P_PAD * RT; i += NT) {
      const int c = i / RT;
      if (c < P) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q) s += scratch[q * P_PAD * RT + i];
        yT[i] += s + b3[c];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < RT * P_PAD; i += NT) {
    const int r = i / P_PAD, c = i - r * P_PAD;
    if (r < nrows) out[(size_t)(r0 + r) * P_PAD + c] = yT[c * RT + r];
  }
}

}  // namespace

extern "C" int h36x_joint_regressor(const float* phi, const float* w1,
                                    const float* b1, const float* w2,
                                    const float* b2, const float* w3,
                                    const float* b3, float* out, int N, int D,
                                    int H, int P, int iters, void* stream) {
  const size_t scratch = (size_t)(KC > NQ * P_PAD ? KC : NQ * P_PAD) * RT;
  const size_t smem = ((size_t)3 * H * RT + (size_t)P_PAD * RT + scratch) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      regressor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it too
    return (int)err;
  }
  const int blocks = (N + RT - 1) / RT;
  regressor_kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      phi, w1, b1, w2, b2, w3, b3, out, N, D, H, P, iters);
  return (int)cudaGetLastError();
}
