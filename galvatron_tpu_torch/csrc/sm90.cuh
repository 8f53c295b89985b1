// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// TMA tile loads, mbarriers, wgmma descriptors and instructions, register
// reallocation, and the host-side tensor-map encoder.
//
// Layout convention: every bf16 operand tile lives in shared memory as TMA
// writes it with CU_TENSOR_MAP_SWIZZLE_128B: boxes of `rows` x 64 columns
// (128 bytes a row), 16-byte chunks of row r XOR-swizzled by r % 8, each box
// 1024-byte aligned. A head_dim-128 tile is two such boxes (columns 0-63 and
// 64-127). wgmma reads them through 128B-swizzle descriptors:
//   K-major (the product's depth is contiguous, as q and k are along
//   head_dim): SBO = 1024 bytes between 8-row groups, LBO unused; the k-th
//   16-element slice of a box starts 32 * k bytes in.
//   MN-major (the output dimension is contiguous, as v is along head_dim in
//   P.V): LBO = the byte distance between the two 64-column boxes, SBO =
//   1024 bytes between 8-row groups of the depth (8 keys); the k-th
//   16-row slice starts 2048 * k bytes in.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, nothing linked from libcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// A wait that outlasts this traps (an error the host sees) instead of hanging
// the card: no correct pipeline waits this long.
constexpr unsigned long long kWaitLimitNs = 4000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after the inits, before any other thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival, and `bytes` more transaction bytes for the current phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed. A barrier starts in
// phase 0, so a consumer's first wait passes parity 0 (it blocks until the
// first completion) and a producer's first wait on an empty slot passes
// parity 1 (it returns at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// ---------------------------------------------------------------------- TMA
// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first, into shared memory; completes `bytes` on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (TMA, wgmma) before they read them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers among a CTA's warps (id 0 is __syncthreads): `sync` waits
// until `threads` threads have arrived, `arrive` counts and goes on.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x on the special-function unit (ex2.approx, flush to zero; -inf -> 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --------------------------------------------------------------------- wgmma
// 128B-swizzle shared-memory matrix descriptor; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_k_major(uint32_t smem_addr) {
  return desc_sw128(smem_addr, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t smem_addr, uint32_t box_bytes) {
  return desc_sw128(smem_addr, box_bytes, 1024);
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

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define GALV_ACC8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define GALV_ACC32 GALV_ACC8(0), GALV_ACC8(8), GALV_ACC8(16), GALV_ACC8(24)
#define GALV_ACC64 GALV_ACC32, GALV_ACC8(32), GALV_ACC8(40), GALV_ACC8(48), GALV_ACC8(56)
#define GALV_REGS32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define GALV_REGS64                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "   \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "    \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D (64 x 64, fp32) (+)= A (64 x 16, smem, K-major) . B (16 x 64, smem, K-major);
// scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GALV_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : GALV_ACC32
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) (+)= A (64 x 16, smem, K-major) . B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " GALV_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : GALV_ACC64
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16 bf16 in registers, the accumulator layout
// of a product packed in pairs) . B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs_mn(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " GALV_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : GALV_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef GALV_ACC8
#undef GALV_ACC32
#undef GALV_ACC64
#undef GALV_REGS32
#undef GALV_REGS64

// ---------------------------------------------------------- register budget
// Must sit at the head of each branch of one if/else over warpgroup roles
// that never reconverges, or ptxas ignores it (warning C7508).
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ------------------------------------------------------------------ host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
inline cudaError_t encode_tiled_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// A 4-D map over a bf16 BSNH tensor with head_dim 128 read through element
// strides (sb, ss, sh): dims {D, S, H, B}, boxes of 64 columns x `box_rows`
// sequence rows of one (head, batch), 128-byte swizzle. Rows past S read as
// zeros. The stride of a size-1 dim is never used; it is set to the row
// stride so the encoder sees a valid value.
inline cudaError_t encode_bsnh(CUtensorMap* map, const void* base, int B, int S, int H,
                               long long sb, long long ss, long long sh, int box_rows) {
  EncodeTiledFn fn;
  cudaError_t err = encode_tiled_fn(&fn);
  if (err != cudaSuccess) return err;
  if (H == 1) sh = ss;
  if (B == 1) sb = ss;
  const cuuint64_t dims[4] = {128, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                    strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
