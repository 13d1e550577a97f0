// Fused iterative-error-feedback joint regressor, sm_90a.
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
// Two routes, as h36x's `precise` switch: the precise route (FP32, one
// launch) and the fast route (bf16 weights, the activations phi, h1, h2 and
// y as bf16 pairs, products summed in f32 on the tensor cores; y itself is
// carried in f32).
//
// What bounds it on the H100: at the serving shape (N = B*T = 640, D = H =
// 1024, P = 51, 3 rounds) about 5.9 GFLOP over 7.2 MB of bf16 weights and
// f32 activations: operations, 0.006 ms at the bf16 peak (0.086 ms at the
// FP32 peak). At N 1 (one streamed frame) it is the 4.4 MB of bf16
// weights, 0.0013 ms.
//
// The precise route: one block per tile of RT = 8 rows keeps pw1, h1, h2 and
// y for its rows in shared memory across all rounds (3 x 32 KB + 10 KB at
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
// known limit of this design (fewer rows a block would fill it, but every
// block re-reads all weights from L2).
//
// The fast route (D and H multiples of 64): two launches, a cast and one
// persistent chain of hopper.cuh's TMA + wgmma GEMMs (launch_chain), each
// phase with its own fused epilogue and a grid-wide barrier between phases
// (each reads what the one before wrote): one launch pays the kernel's
// start-up once where nine would pay it nine times, which at a few rows is
// more than the GEMMs' work (PERF.md).
// The weights are single bf16 values; the activations (phi, h1, h2 and
// the iterate y) are carried as bf16 pairs (hi, lo: about 16 significant
// bits), read as A = [hi | lo] against the same B rows (hopper.cuh's
// two K segments), as the temporal kernel's fast route carries its activation
// (temporal.cu): a single bf16 rounding of an activation that is itself a
// sum of products makes the result jump wherever two summation orders of
// that sum round to neighbouring bf16 values, and such jumps cascade
// through the rounds. With the pairs the result is a continuous function
// of those sums, and its error against float32 is the weights' rounding.
//   0. phi (f32) to a bf16 pair (and the chain's barrier counters to 0);
//   1. pw1 = phi @ W1p (K = 2 x D), kept in f32; the same epilogue writes
//      round 1's h1 = relu(pw1 + b1) (y = 0 there, so y @ W1y vanishes);
//   2. per round: [rounds 2..: h1 = relu(pw1 + y @ W1y + b1), K = 2 x 64];
//      h2 = relu(h1 @ W2 + b2); y += h2 @ W3p + b3, y kept in f32 and as a
//      pair for the next round's A.
// The weights are read as they lie, (K, N), MN-major by TMA, from the bf16
// copies the caller made once (W1y padded to 64 rows, W3p to 64 columns,
// with zeros). Every phase has 64-column tiles, so that at a few rows the
// 1024-wide phases still spread over 16 SMs. K is not split across blocks
// (measured slower at these sizes, PERF.md), and nothing depends on the
// order in which blocks run: the result is the same bit for bit from run
// to run. The op counts one call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// ---- the fast route ---------------------------------------------------------

namespace hp = h36x_hopper;

// grid-stride: phi (f32) -> a bf16 pair, and the chain's barrier counters
// to zero
__global__ void cast_phi(const float* __restrict__ phi, __nv_bfloat16* __restrict__ hi,
                         __nv_bfloat16* __restrict__ lo, long long n,
                         unsigned* __restrict__ sync, int n_sync) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i0 < n_sync) sync[i0] = 0;
  for (long long i = i0; i < n; i += stride) {
    const float v = phi[i];
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    hi[i] = h;
    lo[i] = __float2bfloat16_rn(v - __bfloat162float(h));
  }
}

enum Stage { kPw1 = 0, kH1 = 1, kH2 = 2, kY = 3 };

// v as a bf16 pair: hi = bf16(v), lo = bf16(v - hi) (v - hi is exact in
// f32), about 16 significant bits
__device__ __forceinline__ void store_pair(__nv_bfloat16* hi, __nv_bfloat16* lo, long long off,
                                           float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + off) = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
}

// The chain's epilogues, one per stage, chosen at run time (uniform across
// the grid), from the accumulators; activations go out as bf16 pairs
// (store_pair), f32 as pairs of floats:
//   kPw1: pw1 = acc (f32), h1 = relu(acc + b1)
//   kH1:  h1 = relu(pw1 + acc + b1)
//   kH2:  h2 = relu(acc + b2)
//   kY:   y = y + acc + b3 (f32; y = acc + b3 in round 1), and y as a pair;
//         b3 has P columns, the rest of the 64 add 0
struct ChainEpi {
  struct Args {
    int stage, first, P;
    const float* bias;
    float* f32;            // kPw1: pw1 out; kH1: pw1 in; kY: y in and out
    __nv_bfloat16* hi;     // h1, h2 or y out, as a pair
    __nv_bfloat16* lo;
  };
  template <int BN>
  static constexpr int bytes() {
    return 0;
  }
  template <int BN>
  __device__ static void store(float (&d)[BN / 2], const Args& a, long long M, int N,
                               long long m0, int n0, uint8_t*, int, int tid) {
    const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long m = m0 + 16 * warp + (lane >> 2) + 8 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        const long long off = m * N + n;
        float v0 = d[4 * j + 2 * i], v1 = d[4 * j + 2 * i + 1];
        if (a.stage == kY) {
          if (!a.first) {
            const float2 y = *reinterpret_cast<const float2*>(a.f32 + off);
            v0 = y.x + v0;
            v1 = y.y + v1;
          }
          v0 += n < a.P ? a.bias[n] : 0.f;
          v1 += n + 1 < a.P ? a.bias[n + 1] : 0.f;
          *reinterpret_cast<float2*>(a.f32 + off) = make_float2(v0, v1);
          store_pair(a.hi, a.lo, off, v0, v1);
          continue;
        }
        if (a.stage == kPw1) {
          *reinterpret_cast<float2*>(a.f32 + off) = make_float2(v0, v1);
        } else if (a.stage == kH1) {
          const float2 pw = *reinterpret_cast<const float2*>(a.f32 + off);
          v0 = pw.x + v0;
          v1 = pw.y + v1;
        }
        const float2 b = *reinterpret_cast<const float2*>(a.bias + n);
        store_pair(a.hi, a.lo, off, fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
      }
    }
  }
};

// every phase at BN = 64: y is 64 columns wide, and the 1024-wide phases
// get 16 column tiles, so that a few rows still spread over 16 SMs
using ChainGemm = hp::Gemm<__nv_bfloat16, 64, true, false, ChainEpi>;
constexpr int MAX_PHASES = 12;  // 3 per round; more rounds take more launches
using Chain = hp::ChainParams<ChainEpi, MAX_PHASES>;

// The fast route's workspace, 1024-aligned pieces: phi (N, D), then pw1 (N,
// H) f32, then h1 and h2 (N, H) and y (N, 64); phi, h1, h2 and y as bf16
// pairs (hi, then lo); then the chain launches' barrier counters.
constexpr int MAX_LAUNCHES = 256;  // of MAX_PHASES phases each: 1024 rounds

struct ChainPlan {
  size_t phi, pw1, h, yb;
  size_t total() const { return 2 * phi + pw1 + 4 * h + 2 * yb + MAX_LAUNCHES * 4; }
};

size_t round_up(size_t v) { return (v + 1023) / 1024 * 1024; }

ChainPlan chain_plan(int N, int D, int H) {
  return {round_up((size_t)N * D * 2), round_up((size_t)N * H * 4), round_up((size_t)N * H * 2),
          round_up((size_t)N * 64 * 2)};
}

// one phase of the chain: A = [hi | lo], the two halves of a bf16 pair (N,
// K each) by TMA, read against the same rows of B (K, cols), bf16 as it lies
int phase(hp::Params<ChainEpi>& p, long long N, int K, int cols, const void* hi,
          const void* lo, const void* w, ChainEpi::Args epi) {
  p = hp::Params<ChainEpi>{};
  int err = hp::make_map(&p.a[0], hi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, N, 2ull * K, 64,
                         hp::BM);
  if (!err)
    err = hp::make_map(&p.a[1], lo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, K, N, 2ull * K, 64,
                       hp::BM);
  if (!err) err = hp::make_map(&p.b[0], w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cols, K,
                               2ull * cols, 64, 64);
  p.M = N;
  p.N = cols;
  hp::add_seg(p, 0, 0, K);
  hp::add_seg(p, 1, 0, K);
  p.epi = epi;
  return err;
}

}  // namespace

extern "C" int h36x_joint_regressor(const float* phi, const float* w1,
                                    const float* b1, const float* w2,
                                    const float* b2, const float* w3,
                                    const float* b3, float* out, int N, int D,
                                    int H, int P, int iters, void* stream) {
  const size_t scratch = (size_t)(KC > NQ * P_PAD ? KC : NQ * P_PAD) * RT;
  const size_t smem = ((size_t)3 * H * RT + (size_t)P_PAD * RT + scratch) * sizeof(float);
  // raised once per device, to the largest size asked for so far, so that a
  // launch inside a CUDA graph capture makes no other runtime call
  static size_t smem_set[64] = {};
  if (int err = hp::raise_smem(smem_set, regressor_kernel, smem)) return err;
  const int blocks = (N + RT - 1) / RT;
  regressor_kernel<<<blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      phi, w1, b1, w2, b2, w3, b3, out, N, D, H, P, iters);
  return (int)cudaGetLastError();
}

// bytes of the fast route's workspace (0: shapes it does not take: D or H
// not a multiple of 64, P above 64, or no rows)
extern "C" size_t h36x_joint_regressor_fast_workspace(int N, int D, int H, int P) {
  if (N <= 0 || D % 64 || H % 64 || D <= 0 || H <= 0 || P <= 0 || P > P_PAD) return 0;
  return chain_plan(N, D, H).total();
}

// The fast route. w1p (D, H), w1y (64, H), w2 (H, H), w3p (H, 64): the bf16
// copies; b1, b2 (H,) and b3 (P,) f32; out (N, 64) f32 (y); ws holds
// h36x_joint_regressor_fast_workspace(N, D, H, P) bytes, 1024-aligned.
// iters >= 1. Returns the first launch's CUDA error, or 0.
extern "C" int h36x_joint_regressor_fast(const float* phi, const void* w1p, const void* w1y,
                                         const void* w2, const void* w3p, const float* b1,
                                         const float* b2, const float* b3, void* ws,
                                         float* out, int N, int D, int H, int P, int iters,
                                         void* stream) {
  const int launches = (3 * iters + MAX_PHASES - 1) / MAX_PHASES;
  if (h36x_joint_regressor_fast_workspace(N, D, H, P) == 0 || iters < 1 ||
      launches > MAX_LAUNCHES)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ChainPlan c = chain_plan(N, D, H);
  uint8_t* base = static_cast<uint8_t*>(ws);
  __nv_bfloat16* phi_b = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* phi_lo = reinterpret_cast<__nv_bfloat16*>(base += c.phi);
  float* pw1 = reinterpret_cast<float*>(base += c.phi);
  __nv_bfloat16* h1 = reinterpret_cast<__nv_bfloat16*>(base += c.pw1);
  __nv_bfloat16* h1_lo = reinterpret_cast<__nv_bfloat16*>(base += c.h);
  __nv_bfloat16* h2 = reinterpret_cast<__nv_bfloat16*>(base += c.h);
  __nv_bfloat16* h2_lo = reinterpret_cast<__nv_bfloat16*>(base += c.h);
  __nv_bfloat16* yb = reinterpret_cast<__nv_bfloat16*>(base += c.h);
  __nv_bfloat16* yb_lo = reinterpret_cast<__nv_bfloat16*>(base += c.yb);
  unsigned* sync = reinterpret_cast<unsigned*>(base += c.yb);

  const long long n = (long long)N * D;
  const long long want = (n + 255) / 256;
  cast_phi<<<(int)(want < 1024 ? want : 1024), 256, 0, s>>>(phi, phi_b, phi_lo, n, sync,
                                                           launches);
  int err = (int)cudaGetLastError();
  if (err) return err;

  // the phases: pw1 (and round 1's h1), then per round [h1,] h2, y; in
  // launches of at most MAX_PHASES, each with its own barrier counter
  Chain chain{};
  int launch = 0;
  auto add = [&](int K, int cols, const void* hi, const void* lo, const void* w,
                 ChainEpi::Args epi) {
    if (err) return;
    err = phase(chain.ph[chain.phases++], N, K, cols, hi, lo, w, epi);
    if (!err && chain.phases == MAX_PHASES) {
      chain.sync = sync + launch++;
      err = hp::launch_chain<ChainGemm, MAX_PHASES>(chain, s);
      chain.phases = 0;
    }
  };
  add(D, H, phi_b, phi_lo, w1p, {kPw1, 0, P, b1, pw1, h1, h1_lo});
  for (int it = 0; it < iters; ++it) {
    if (it > 0) add(P_PAD, H, yb, yb_lo, w1y, {kH1, 0, P, b1, pw1, h1, h1_lo});
    add(H, H, h1, h1_lo, w2, {kH2, 0, P, b2, nullptr, h2, h2_lo});
    add(H, P_PAD, h2, h2_lo, w3p, {kY, it == 0, P, b3, out, yb, yb_lo});
  }
  if (!err && chain.phases > 0) {
    chain.sync = sync + launch++;
    err = hp::launch_chain<ChainGemm, MAX_PHASES>(chain, s);
  }
  return err;
}
