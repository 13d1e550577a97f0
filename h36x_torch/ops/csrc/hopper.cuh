// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels of
// matmul_probe.cu (B6), bottleneck.cu (B5) and the fast routes of
// temporal.cu (B1) and regressor.cu (B3): TMA tensor maps, mbarriers, bulk
// and 16-byte asynchronous copies, wgmma descriptors and instructions,
// setmaxnreg, and on top of them one warp-specialised persistent GEMM
// mainloop that all four instantiate.
//
// The mainloop (gemm_kernel below). A block of 384 threads stays on one SM
// and walks the output tiles t = blockIdx.x, blockIdx.x + gridDim.x, ...
// (BM = 128 rows x BN columns, the n tile varying fastest). Warpgroup 0 is
// the producer: it keeps a ring of STAGES (A, B) tiles in shared memory, one
// 128-byte swizzle row of K deep each (64 bf16 or 128 int8), filled by TMA
// (one thread) or, for the implicit 3x3 convolution, by 16-byte cp.async
// with zero fill (all 128 threads), and gives its registers to the consumers
// (setmaxnreg). Warpgroups 1 and 2 each own 64 rows of the tile and run
// wgmma m64nBN on every stage that has arrived (full barrier), releasing it
// (empty barrier) as soon as the next stage's products are issued, so that
// the producer refills it while they multiply; across tiles the ring keeps
// loading, so one tile's epilogue overlaps the next tile's loads. The
// epilogue is the caller's (a class with Args, bytes<BN>() and store<BN>()).
// K may be several segments one after the other, each a pair of tensor
// maps (A, B) read from its own first row: two different operands against
// the rows of one longer B ([b | x] @ [W3; Wp], B5's projection block, B
// read from a row offset), the hi and lo halves of one bf16 pair against
// the same rows of B read again (the fast routes of B1 and B3), or the
// passes of a product of float32 operands split into bf16 parts
// (split_passes: the backward kernels B2 and B4, three parts each, six
// passes). A segment's length is a multiple of the K stage; TMA's zero
// fill past an exact tensor map pads a shorter contraction.
// A is K-major, or MN-major (A_MN: a (K, M) row-major tensor, the X of a
// weight gradient X^T G, read as it lies through wgmma's transpose bit).
// A GEMM may also be `splits` independent products over consecutive row
// ranges of K (split_k rows each), written one after the other as (splits
// * M, N): partial sums that the caller adds in a fixed order.
//
// Shared-memory layouts are those of TMA's 128-byte swizzle: a K-major tile
// of R rows is R x 128 bytes, 16-byte chunk c of row r at r * 128 +
// ((c ^ (r % 8)) * 16); 8 rows make one 1024-byte swizzle atom. An MN-major
// bf16 tile (a (K, N) row-major B read as it lies: the probe's y, the
// bottleneck's weights, an MN-major A) is BN / 64 (BM / 64) boxes of 64 K
// rows x 64 columns, one after the other.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace h36x_hopper {

// ---- host: TMA tensor maps --------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// libraries need no -lcuda; nullptr if the driver does not offer it
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A row-major (outer, inner) tensor whose rows lie row_bytes apart, cut in
// boxes of (box_outer, box_inner) with 128-byte swizzle; boxes that reach
// past the tensor fill with zeros. Returns a CUDA error code, or 0.
inline int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                    uint64_t inner, uint64_t outer, uint64_t row_bytes, uint32_t box_inner,
                    uint32_t box_outer) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the current device's index, 0..63 (the slot of the per-device tables
// below; cudaGetDevice is no stream work, so a graph capture allows it)
inline int device_slot() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return dev < 0 || dev >= 64 ? 0 : dev;
}

// the current device's SM count, asked of the runtime once per device
inline int sm_count() {
  static int counts[64] = {};
  const int dev = device_slot();
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      cudaGetLastError();
      return 132;
    }
    counts[dev] = n;
  }
  return counts[dev];
}

// Raise `kernel`'s dynamic shared-memory limit on the current device to
// `bytes`, once per device and size (`set` is the caller's per-device
// table of the largest size set so far), so that a launch inside a CUDA
// graph capture makes no other runtime call. Returns the CUDA error, or 0.
template <class K>
int raise_smem(size_t (&set)[64], K kernel, size_t bytes) {
  const int dev = device_slot();
  if (bytes <= set[dev]) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it too
    return (int)err;
  }
  set[dev] = bytes;
  return 0;
}

// ---- device: barriers and copies ----------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of asynchronous copies to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// announces `bytes` of asynchronous copies without arriving
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed; a wait of some 2^34
// cycles (seconds, where a stage takes microseconds) is a broken protocol,
// and traps rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// TMA: the box at element coordinates (c0 inner, c1 outer) into shared memory,
// completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (nothing is read)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// the barrier counts one more pending arrival, which happens when every
// cp.async this thread has issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// orders generic-proxy writes to shared memory (cp.async's included) that
// this thread has observed before its later async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- device: wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned swizzle atoms). K-major: sbo = 1024 (8 rows of 128
// bytes), lbo unused (16). MN-major: lbo = the bytes between two 64-column
// blocks, sbo = 1024 (8 K rows).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma instructions (their registers are written late)
__device__ __forceinline__ void fence_reg(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void fence_reg(int& v) { asm volatile("" : "+r"(v)::"memory"); }

template <typename A, int N>
__device__ __forceinline__ void fence_acc(A (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(d[i]);
}

// D (64 x N per warpgroup, f32 or s32 in registers) += A (64 x K, shared;
// TRANS_A = 1: MN-major) . B (K x N, shared; TRANS_B = 1: MN-major). bf16
// takes K = 16, s8 K = 32 (K-major only); scale_d = 0 overwrites D. Thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + 8 i and columns 8 j +
// 2 (t % 4) + c at d[4 j + 2 i + c].

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, %36, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %68, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, %132, %131;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


template <typename T>
struct MmaOf;
template <>
struct MmaOf<__nv_bfloat16> {
  using Acc = float;
};
template <>
struct MmaOf<int8_t> {
  using Acc = int;
};

// one wgmma over 32 bytes of K (16 bf16, 32 int8) for a 64 x BN warpgroup tile
template <typename T, int BN, bool A_MN, bool B_MN>
__device__ __forceinline__ void mma_32b(typename MmaOf<T>::Acc (&d)[BN / 2], uint64_t da,
                                        uint64_t db, int scale_d) {
  if constexpr (sizeof(T) == 1) {
    static_assert(!A_MN && !B_MN, "s8 wgmma takes K-major operands only");
    static_assert(BN == 128 || BN == 256, "s8 tile widths");
    if constexpr (BN == 256) {
      wgmma_s8_n256(d, da, db, scale_d);
    } else {
      wgmma_s8_n128(d, da, db, scale_d);
    }
  } else {
    static_assert(BN == 64 || BN == 128 || BN == 256, "bf16 tile widths");
    if constexpr (BN == 256) {
      wgmma_bf16_n256<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, db, scale_d);
    } else if constexpr (BN == 128) {
      wgmma_bf16_n128<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, db, scale_d);
    } else {
      wgmma_bf16_n64<A_MN ? 1 : 0, B_MN ? 1 : 0>(d, da, db, scale_d);
    }
  }
}

// ---- the warp-specialised persistent GEMM ----------------------------------------

constexpr int BM = 128;           // rows of an output tile: two consumer warpgroups of 64
constexpr int ROW_BYTES = 128;    // bytes of K a stage holds: one swizzle row
constexpr int THREADS = 384;      // the producer warpgroup and two consumer warpgroups
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may ask for on the H100

// A of the implicit 3x3 SAME convolution: tap (dy, dx) of pixel m of an
// (M = B*H*W, C) NHWC batch, zero outside its image
struct Im2col {
  const __nv_bfloat16* a;
  int C, H, W;
};

// one segment of K: columns [the previous segment's end, end) read A map
// `a` and B map `b` from their row 0 (B from row b_off), both K rows on
struct KSeg {
  int end, a, b, b_off;
};

// MAPS tensor maps each of A and B, up to MAPS (MAPS + 1) / 2 segments:
// with MAPS = 3, the six passes of a product of two float32 operands split
// into three bf16 parts each (split_passes)
template <class Epi, int MAPS = 2>
struct Params {
  static constexpr int SEGS = MAPS * (MAPS + 1) / 2;
  // A K-major (M, K): box (BM rows, 128 bytes); MN-major (K, M): box (64, 64)
  CUtensorMap a[MAPS];
  // B K-major (N, K): box (BN rows, 128 bytes); MN-major (K, N): box (64, 64)
  CUtensorMap b[MAPS];
  long long M;
  int N, K;        // K: the end of the last segment
  int segs;        // 1 .. SEGS
  KSeg seg[SEGS];
  int splits;      // 0 or 1: one product; more: one per split_k rows of K
  int split_k;     // rows of each segment's tensors a split reads, a multiple of BK
  Im2col im;       // IM2COL: A comes from here instead (and B from b[0])
  typename Epi::Args epi;
};

// appends a segment of `len` K columns (a multiple of the K stage: TMA
// fills past the tensor with zeros) reading A map a and B map b
template <class P>
inline void add_seg(P& p, int a, int b, int len, int b_off = 0) {
  p.K += len;
  p.seg[p.segs++] = KSeg{p.K, a, b, b_off};
}

// the passes of a product whose operands are split into `parts` bf16 parts
// (maps 0 .. parts-1, largest first), each `len` K columns: every (i, j)
// with i + j < parts, largest first. Three parts: a.b to about 2^-27 of
// each product, below float32's own rounding
template <class P>
inline void split_passes(P& p, int parts, int len) {
  for (int s = 0; s < parts; ++s)
    for (int i = 0; i <= s; ++i) add_seg(p, i, s - i, len);
}

// the shapes fit G: N % BN, every segment's length % BK and K >= BK
template <class G>
inline bool fits(const typename G::P& p) {
  if (p.N <= 0 || p.N % G::BN || p.K < G::BK || p.segs < 1 || p.segs > G::P::SEGS)
    return false;
  int start = 0;
  for (int s = 0; s < p.segs; ++s) {
    if (p.seg[s].end <= start || (p.seg[s].end - start) % G::BK) return false;
    start = p.seg[s].end;
  }
  return start == p.K && (p.splits <= 1 || (p.split_k > 0 && p.split_k % G::BK == 0));
}

template <class P>
__host__ __device__ __forceinline__ int split_count(const P& p) {
  return p.splits > 1 ? p.splits : 1;
}

// PROMOTE (> 0): every PROMOTE K stages' products go into a fresh wgmma
// accumulator that is then added into a separate f32 sum (round to
// nearest): the tensor cores' own accumulation across a long chain of
// stages loses low bits in one direction, an error that grows with K
// (PERF.md); a window's products then share one short chain
template <typename T, int BN_, bool B_MN_, bool IM2COL_, class Epi_, bool A_MN_ = false,
          int MAPS_ = 2, int PROMOTE_ = 0>
struct Gemm {
  using Elem = T;
  using Epi = Epi_;
  using Acc = typename MmaOf<T>::Acc;
  using P = Params<Epi, MAPS_>;
  static constexpr int BN = BN_;
  static constexpr bool A_MN = A_MN_, B_MN = B_MN_, IM2COL = IM2COL_;
  static constexpr int PROMOTE = PROMOTE_;
  static constexpr int BK = ROW_BYTES / (int)sizeof(T);  // K elements a stage
  static constexpr int A_BYTES = BM * ROW_BYTES, B_BYTES = BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int EPI_WG_BYTES = Epi::template bytes<BN>();  // staging, per consumer
  // alignment slack, the two consumers' staging, up to 2 x 8 barriers
  static constexpr int FIXED_BYTES = 1024 + 2 * EPI_WG_BYTES + 128;
  static constexpr int FIT = (SMEM_MAX - FIXED_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT > 6 ? 6 : FIT;
  static constexpr int SMEM_BYTES = FIXED_BYTES + STAGES * STAGE_BYTES;
  // the producer's 16-byte copiers need more registers than one TMA thread
  static constexpr int PRODUCER_REGS = IM2COL ? 56 : 40;
  static constexpr int CONSUMER_REGS = IM2COL ? 224 : 232;
  static_assert(STAGES >= 2, "a ring");
  static_assert(!B_MN || sizeof(T) == 2, "MN-major B is bf16 only");
  static_assert(!A_MN || (sizeof(T) == 2 && !IM2COL), "MN-major A is bf16 by TMA only");
  static_assert(!IM2COL || sizeof(T) == 2, "the implicit convolution is bf16 only");
  static_assert(!PROMOTE || sizeof(T) == 2, "promotion sums f32 accumulators");
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536, "register file");
};

// the B tile of K rows k0 .. and columns n0 .. by TMA: K-major one (BN, 128
// bytes) box; MN-major BN / 64 boxes of 64 K rows x 64 columns, one after
// the other
template <class G>
__device__ __forceinline__ void load_b(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                       int k0, int n0) {
  if constexpr (G::B_MN) {
#pragma unroll
    for (int j = 0; j < G::BN / 64; ++j)
      tma_load_2d(dst + j * G::BK * ROW_BYTES, map, bar, n0 + 64 * j, k0);
  } else {
    tma_load_2d(dst, map, bar, k0, n0);
  }
}

// the A tile of rows m0 .. and K columns k0 ..: K-major one (BM, 128 bytes)
// box; MN-major two boxes of 64 K rows x 64 columns (rows), the second
// skipped when it lies wholly past M (its rows' sums are never stored)
template <class G>
__device__ __forceinline__ void load_a(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                       int k0, int m0, long long M) {
  if constexpr (G::A_MN) {
    tma_load_2d(dst, map, bar, m0, k0);
    if (m0 + 64 < M) tma_load_2d(dst + G::BK * ROW_BYTES, map, bar, m0 + 64, k0);
  } else {
    tma_load_2d(dst, map, bar, k0, m0);
  }
}

// output tile t of a GEMM: its split, first row and first column
struct TileAt {
  int split, m0, n0;
};

__device__ __forceinline__ TileAt tile_at(long long t, long long per_split, int tiles_n, int bn) {
  const int s = (int)(t / per_split);
  const long long r = t - s * per_split;
  return TileAt{s, (int)(r / tiles_n) * BM, (int)(r % tiles_n) * bn};
}

template <class G>
__device__ __forceinline__ void produce_tma(const typename G::P& p, uint8_t* ring,
                                            uint64_t* full, uint64_t* empty, long long tiles,
                                            int tiles_n, int nk, int& stage, uint32_t& phase) {
  const long long per_split = tiles / split_count(p);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt at = tile_at(t, per_split, tiles_n, G::BN);
    const int k_base = at.split * p.split_k;
    int s = 0, start = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * G::BK;
      if (k0 >= p.seg[s].end) start = p.seg[s++].end;
      const KSeg& sg = p.seg[s];
      mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* a_dst = ring + stage * G::STAGE_BYTES;
      const int ka = k0 - start + k_base;
      // an MN-major A whose second box lies past M asks for one box only
      const uint32_t a_bytes =
          G::A_MN && at.m0 + 64 >= p.M ? G::A_BYTES / 2 : G::A_BYTES;
      mbar_arrive_expect_tx(&full[stage], a_bytes + G::B_BYTES);
      load_a<G>(a_dst, &p.a[sg.a], &full[stage], ka, at.m0, p.M);
      load_b<G>(a_dst + G::A_BYTES, &p.b[sg.b], &full[stage], ka + sg.b_off, at.n0);
      if (++stage == G::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// All 128 producer threads fill the A tile of the implicit convolution: thread
// tid copies 16-byte chunk tid % 8 of rows tid / 8 + 16 i. The pixel of each
// row and which of its 9 taps lie inside the image are found once per tile;
// a stage of K (BK channels, C a multiple of BK) lies within one tap. Each
// thread's arrival on a stage's full barrier waits, in the barrier, for its
// copies to land (cp.async.mbarrier.arrive), so the producer never waits on
// its own copies, only on free stages. Thread 0 also loads the B tile by TMA.
template <class G>
__device__ __forceinline__ void produce_im2col(const typename G::P& p, uint8_t* ring,
                                               uint64_t* full, uint64_t* empty,
                                               long long tiles, int tiles_n, int nk,
                                               int tid) {
  const int j = tid & 7, r0 = tid >> 3;
  const __nv_bfloat16* a = p.im.a;
  const int C = p.im.C, H = p.im.H, W = p.im.W;
  const int hw = H * W;
  int stage = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (int)(t / tiles_n) * BM, n0 = (int)(t % tiles_n) * G::BN;
    int row[BM / 16];
    uint32_t taps[BM / 16];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) {
      const int m = m0 + r0 + 16 * i;
      row[i] = m;
      taps[i] = 0;
      if (m < p.M) {
        const int pix = m % hw, y = pix / W, x = pix - (pix / W) * W;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) taps[i] |= 1u << tap;
        }
      }
    }
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      uint8_t* a_dst = ring + stage * G::STAGE_BYTES;
      const int k0 = kt * G::BK;
      if (tid == 0) {
        mbar_expect_tx(&full[stage], G::B_BYTES);
        load_b<G>(a_dst + G::A_BYTES, &p.b[0], &full[stage], k0, n0);
      }
      const int tap = k0 / C, c0 = k0 - tap * C;
      const int shift = (tap / 3 - 1) * W + (tap % 3 - 1);
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        const int r = r0 + 16 * i;
        const bool valid = (taps[i] >> tap) & 1u;
        const __nv_bfloat16* src = valid ? a + (long long)(row[i] + shift) * C + c0 + 8 * j : a;
        cp_async_16(a_dst + r * ROW_BYTES + ((j ^ (r & 7)) << 4), src, valid);
      }
      cp_async_arrive(&full[stage]);
      mbar_arrive(&full[stage]);
      if (++stage == G::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// the wgmmas of one K stage (128 bytes of K) into accumulator d; acc: add
// to what d holds (else the first k step overwrites it)
template <class G>
__device__ __forceinline__ void stage_mma(typename G::Acc (&d)[G::BN / 2], uint32_t a_addr,
                                          uint32_t b_addr, bool acc) {
#pragma unroll
  for (int kk = 0; kk < ROW_BYTES / 32; ++kk) {
    // MN-major: a k step is 16 rows of 128 bytes; K-major: 32 bytes of a row
    const uint64_t da =
        G::A_MN ? desc_sw128(a_addr + 16 * ROW_BYTES * kk, G::BK * ROW_BYTES, 1024)
                : desc_sw128(a_addr + 32 * kk, 16, 1024);
    const uint64_t db =
        G::B_MN ? desc_sw128(b_addr + 16 * ROW_BYTES * kk, G::BK * ROW_BYTES, 1024)
                : desc_sw128(b_addr + 32 * kk, 16, 1024);
    mma_32b<typename G::Elem, G::BN, G::A_MN, G::B_MN>(d, da, db, acc || kk != 0);
  }
}

// sum (+)= d, element by element in f32 (first: sum = d)
template <int N>
__device__ __forceinline__ void add_acc(float (&sum)[N], const float (&d)[N], bool first) {
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] = first ? d[i] : sum[i] + d[i];
}

// One consumer warpgroup: rows 64 wg .. 64 wg + 63 of every tile. A stage is
// released (one arrival per warp) once the next stage's wgmmas are issued and
// its own have completed.
template <class G>
__device__ __forceinline__ void consume(const typename G::P& p, uint8_t* ring, uint8_t* epi,
                                        uint64_t* full, uint64_t* empty, long long tiles,
                                        int tiles_n, int nk, int wg, int tid, int& stage,
                                        uint32_t& phase) {
  const uint32_t ring_addr = smem_u32(ring);
  const int lane = tid & 31;
  const long long per_split = tiles / split_count(p);
  typename G::Acc d[G::BN / 2];
  // PROMOTE: a second accumulator, the windows taking the two in turn so that
  // one window's products run while the other's are added, and the f32 sum
  constexpr int W = G::PROMOTE > 0 ? G::PROMOTE : 1;
  typename G::Acc d2[G::PROMOTE ? G::BN / 2 : 1];
  float sum[G::PROMOTE ? G::BN / 2 : 1];
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt at = tile_at(t, per_split, tiles_n, G::BN);
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(&full[stage], phase);
      if constexpr (G::IM2COL) fence_proxy_async();  // A came by cp.async
      // this warpgroup's 64 rows: 64 rows of 128 bytes K-major, the wg-th
      // box of 64 K rows x 64 columns MN-major, 8 KB either way
      const uint32_t a_addr = ring_addr + stage * G::STAGE_BYTES + wg * 64 * ROW_BYTES;
      const uint32_t b_addr = ring_addr + stage * G::STAGE_BYTES + G::A_BYTES;
      wgmma_fence();
      if constexpr (G::PROMOTE) {
        if ((kt / W) & 1) {
          stage_mma<G>(d2, a_addr, b_addr, kt % W != 0);
        } else {
          stage_mma<G>(d, a_addr, b_addr, kt % W != 0);
        }
      } else {
        stage_mma<G>(d, a_addr, b_addr, kt != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the stage before this one has completed
      if constexpr (G::PROMOTE) {
        if (kt > 0 && kt % W == 0) {  // ... and closed a window
          if (((kt - 1) / W) & 1) {
            fence_acc(d2);
            add_acc(sum, d2, false);
          } else {
            fence_acc(d);
            add_acc(sum, d, kt == W);
          }
        }
      }
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == G::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if constexpr (G::PROMOTE) {
      if (((nk - 1) / W) & 1) {
        fence_acc(d2);
        add_acc(sum, d2, false);
      } else {
        fence_acc(d);
        add_acc(sum, d, nk <= W);
      }
    } else {
      fence_acc(d);
    }
    if (lane == 0) mbar_arrive(&empty[prev]);
    // split s stores rows s * M .. of a (splits * M, N) output
    const long long row0 = (long long)at.split * p.M;
    auto store = [&](auto& acc) {
      G::Epi::template store<G::BN>(acc, p.epi, row0 + p.M, p.N, row0 + at.m0 + 64 * wg, at.n0,
                                    epi + wg * G::EPI_WG_BYTES, wg, tid);
    };
    if constexpr (G::PROMOTE) {
      store(sum);
    } else {
      store(d);
    }
  }
}

// The shared memory of a block: the ring, the consumers' staging, the full
// and empty barriers
struct Smem {
  uint8_t *ring, *epi;
  uint64_t *full, *empty;
};

// lays out G's shared memory and initialises its barriers; every thread of
// the block calls it
template <class G>
__device__ __forceinline__ Smem setup_smem(uint8_t* smem_raw) {
  Smem m;
  // 128-byte swizzle atoms want 1024-byte aligned tiles
  m.ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  m.epi = m.ring + G::STAGES * G::STAGE_BYTES;
  m.full = reinterpret_cast<uint64_t*>(m.epi + 2 * G::EPI_WG_BYTES);
  m.empty = m.full + G::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&m.full[s], G::IM2COL ? 128 : 1);
      mbar_init(&m.empty[s], 8);  // the 8 consumer warps
    }
    fence_barrier_init();
  }
  __syncthreads();
  return m;
}

template <class G>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(const __grid_constant__ typename G::P p) {
  extern __shared__ uint8_t smem_raw[];
  const Smem m = setup_smem<G>(smem_raw);
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int tiles_n = p.N / G::BN;
  const long long tiles = (p.M + BM - 1) / BM * tiles_n * split_count(p);
  const int nk = p.K / G::BK;
  int stage = 0;
  uint32_t phase = 0;
  // one if / else for the whole kernel: the roles never meet again, so
  // setmaxnreg holds
  if (wg == 0) {
    reg_dealloc<G::PRODUCER_REGS>();
    if constexpr (G::IM2COL) {
      produce_im2col<G>(p, m.ring, m.full, m.empty, tiles, tiles_n, nk, tid);
    } else if (tid == 0) {
      produce_tma<G>(p, m.ring, m.full, m.empty, tiles, tiles_n, nk, stage, phase);
    }
  } else {
    reg_alloc<G::CONSUMER_REGS>();
    consume<G>(p, m.ring, m.epi, m.full, m.empty, tiles, tiles_n, nk, wg - 1, tid, stage, phase);
  }
}

// Launch on `stream` with one persistent block per SM (fewer if there are
// fewer tiles). The shapes must fit G (fits<G>); the caller checks them.
// The shared-memory attribute is set once per
// kernel, at its first launch, so that a launch inside a CUDA graph capture
// makes no other runtime call (per device). Returns the launch's CUDA error, or 0; an
// empty M is a grid of 0 blocks, which the launch refuses.
template <class G>
int launch_gemm(const typename G::P& p, cudaStream_t stream) {
  static size_t smem_set[64] = {};
  const long long tiles = (p.M + BM - 1) / BM * (p.N / G::BN) * split_count(p);
  const long long sms = sm_count();
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
  if (int err = raise_smem(smem_set, gemm_kernel<G>, G::SMEM_BYTES)) return err;
  gemm_kernel<G><<<blocks, THREADS, G::SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- a chain of GEMMs in one persistent launch ----------------------------------
//
// Phase i + 1 reads what phase i wrote (B3's rounds), so phases are
// separated by a grid-wide barrier, and one launch pays the kernel's start
// (barrier set-up, descriptor fetches, the first loads) once for all of
// them. The ring of stages and its barriers carry on from phase to phase.
// Every block must be resident at once: the grid is at most one block per
// SM, the shared memory admits one block per SM, and the launch is
// cooperative, so the runtime starts the blocks together or refuses the
// launch (a chain never waits on blocks that other kernels keep from
// their SMs). TMA-fed A only.

template <class Epi, int MAX>
struct ChainParams {
  Params<Epi> ph[MAX];  // each phase's tensor maps, shapes and epilogue
  int phases;
  unsigned* sync;       // the grid barrier's counter, zero before the launch
};

// orders this thread's generic-proxy global writes before later
// async-proxy (TMA) reads of them, and those reads after the writes it has
// observed
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// all threads of all blocks; `target` = (barriers so far) * gridDim.x. A
// wait of some 2^34 cycles is a block that never came, and traps.
__device__ __forceinline__ void grid_sync(unsigned* sync, unsigned target) {
  named_bar_sync(0, THREADS);
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(sync, 1u);
    const long long t0 = clock64();
    while (*reinterpret_cast<volatile unsigned*>(sync) < target) {
      if (clock64() - t0 > (1ll << 34)) __trap();
    }
    __threadfence();
  }
  named_bar_sync(0, THREADS);
}

template <class G, int MAX>
__global__ void __launch_bounds__(THREADS, 1)
    chain_kernel(const __grid_constant__ ChainParams<typename G::Epi, MAX> c) {
  static_assert(!G::IM2COL, "the chain's A comes by TMA");
  extern __shared__ uint8_t smem_raw[];
  const Smem m = setup_smem<G>(smem_raw);
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  int stage = 0;
  uint32_t phase = 0;
  if (wg == 0) {
    reg_dealloc<G::PRODUCER_REGS>();
  } else {
    reg_alloc<G::CONSUMER_REGS>();
  }
  for (int i = 0; i < c.phases; ++i) {
    const typename G::P& p = c.ph[i];
    const int tiles_n = p.N / G::BN;
    const long long tiles = (p.M + BM - 1) / BM * tiles_n * split_count(p);
    const int nk = p.K / G::BK;
    if (i > 0) grid_sync(c.sync, (unsigned)i * gridDim.x);
    if (wg == 0) {
      if (tid == 0) {
        fence_proxy_async_global();
        produce_tma<G>(p, m.ring, m.full, m.empty, tiles, tiles_n, nk, stage, phase);
      }
    } else {
      consume<G>(p, m.ring, m.epi, m.full, m.empty, tiles, tiles_n, nk, wg - 1, tid, stage,
                 phase);
      fence_proxy_async_global();
    }
  }
}

// Launch the chain on `stream`, cooperatively: one block per SM at most,
// as many as the widest phase has tiles. Each phase must fit G, as for
// launch_gemm. A CUDA graph capture records the cooperative launch as it is.
template <class G, int MAX>
int launch_chain(const ChainParams<typename G::Epi, MAX>& c, cudaStream_t stream) {
  static size_t smem_set[64] = {};
  long long tiles = 1;
  for (int i = 0; i < c.phases; ++i) {
    const long long t =
        (c.ph[i].M + BM - 1) / BM * (c.ph[i].N / G::BN) * split_count(c.ph[i]);
    tiles = t > tiles ? t : tiles;
  }
  const long long sms = sm_count();
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
  if (int err = raise_smem(smem_set, chain_kernel<G, MAX>, G::SMEM_BYTES)) return err;
  cudaLaunchAttribute attr[1] = {};
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = G::SMEM_BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, chain_kernel<G, MAX>, c);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return 0;
}

// ---- epilogue helpers ----------------------------------------------------------

// columns of a consumer's tile staged at a time, and its staging bytes: 64
// rows of 128 or 256 bytes (a wider tile goes out in passes)
template <int BN>
__host__ __device__ constexpr int staged_cols() {
  return BN < 128 ? BN : 128;
}

template <int BN>
__host__ __device__ constexpr int staging_bytes() {
  return 64 * 2 * staged_cols<BN>();
}

// Store a consumer's 64 x BN tile at out[m0 .., n0 ..] (row pitch ldo
// elements), rows at or past M skipped: each value pair of the wgmma
// accumulator layout becomes fin(row in tile, column in tile, v0, v1), a
// bf16 pair, written to the warpgroup's staging buffer (16-byte chunk c of
// row r at chunk c ^ (r % 8), so that both the pair writes and the chunk
// reads hit 32 distinct banks), then copied out as 16-byte row-contiguous
// global stores, staged_cols<BN>() columns per pass.
template <int BN, class Fin>
__device__ __forceinline__ void store_tile_bf16(const float (&v)[BN / 2], __nv_bfloat16* out,
                                                long long M, int ldo, long long m0, int n0,
                                                uint8_t* stage, int wg, int tid, Fin fin) {
  constexpr int COLS = staged_cols<BN>(), PITCH = 2 * COLS, CHUNKS = COLS / 8;
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int pass = 0; pass < BN / COLS; ++pass) {
    named_bar_sync(1 + wg, 128);  // the previous pass's reads of the buffer are done
#pragma unroll
    for (int jj = 0; jj < CHUNKS; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = pass * CHUNKS + jj;
        const int r = 16 * warp + (lane >> 2) + 8 * i;
        *reinterpret_cast<__nv_bfloat162*>(stage + r * PITCH + ((jj ^ (r & 7)) << 4) +
                                           4 * (lane & 3)) =
            fin(r, 8 * j + 2 * (lane & 3), v[4 * j + 2 * i], v[4 * j + 2 * i + 1]);
      }
    named_bar_sync(1 + wg, 128);
#pragma unroll 4
    for (int idx = tid; idx < 64 * CHUNKS; idx += 128) {
      const int r = idx / CHUNKS, ch = idx % CHUNKS;
      if (m0 + r < M)
        *reinterpret_cast<uint4*>(out + (m0 + r) * ldo + n0 + pass * COLS + 8 * ch) =
            *reinterpret_cast<const uint4*>(stage + r * PITCH + ((ch ^ (r & 7)) << 4));
    }
  }
}

// out (M, N) f32 = the accumulators, 8 bytes a thread straight from the
// registers, rows at or past M skipped
struct StoreF32 {
  struct Args {
    float* out;
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
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(a.out + m * N + n0 + 8 * j + 2 * (lane & 3)) =
            make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
    }
  }
};

// v split into three bf16 parts, v0 = bf16(v), v1 = bf16(v - v0), v2 =
// bf16(v - v0 - v1) (each difference exact in f32): float32's 24
// significant bits. Two neighbouring values at `off` of parts that lie
// `half` elements apart.
__device__ __forceinline__ void store_split3(__nv_bfloat16* parts, long long half, long long off,
                                             float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  *reinterpret_cast<__nv_bfloat162*>(parts + off) = h;
  *reinterpret_cast<__nv_bfloat162*>(parts + half + off) = m;
  *reinterpret_cast<__nv_bfloat162*>(parts + 2 * half + off) =
      __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
}

}  // namespace h36x_hopper
