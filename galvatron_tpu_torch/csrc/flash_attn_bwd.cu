// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two backward `pallas_call`s of the TPU kernel behind
// `galvatron_tpu/ops/attention.py::_pallas_flash`
// (jax.experimental.pallas.ops.tpu.flash_attention: `_flash_attention_bwd_dkv`
// and `_flash_attention_bwd_dq`). Given q, k, v, the forward's out and fp32
// logsumexp, and dout, per (batch, head):
//   p  = exp(q k^T * sm_scale + mask - lse)      (recomputed, fp32)
//   di = rowsum(out * dout)                      (fp32)
//   dv = p^T dout,  dp = dout v^T,  ds = p * (dp - di) * sm_scale
//   dq = ds k,      dk = ds^T q
// The masks are the forward's: causal (key <= query) and optional int32
// segment ids; a masked logit gets DEFAULT_MASK_VALUE (-0.7 * f32 max) ADDED,
// so a fully masked tile yields p == 0 exactly and contributes nothing (never
// NaN). Rounding follows the Pallas kernels: p is rounded to the input dtype
// before dv, ds before dq and dk; every product accumulates in fp32; the
// gradients are written in the input dtype.
//
// Layout: q, k, v, out, dout and the three gradients are BSNH, read and
// written in place through their (batch, seq, head) element strides; the head
// dim must be contiguous. lse and di are (B, H, Sq) fp32.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at B=1, S=2048,
// nh=32, hd=128, causal, the five products (q k^T, dv, dp, dq, dk) are
// 10 * hd FLOP per admitted (query, key) pair: ~86 GFLOP, ~87 us, against
// ~134 MB of q/k/v/o/dout/lse read and dq/dk/dv written (~40 us). So the
// kernel is compute-bound.
//
// Design: three passes and no atomics, so the result is deterministic.
//  1. di: one warp per (batch, head, query row) reduces out * dout in fp32.
//  2. dkv: one CTA per (key tile, head, batch) keeps its key tile's dK and dV
//     accumulators for the whole run and loops over the query tiles from the
//     causal diagonal to the end (the Pallas grid's sequential q axis becomes
//     a loop inside the block).
//  3. dq: one CTA per (query tile, head, batch) loops over the key tiles up
//     to the causal diagonal, accumulating dQ.
// Tiles are issued heaviest-first so the causal triangle balances over SMs.
//
// Two implementations behind one entry point, chosen from the inputs:
//
// * bf16, head_dim 128, 16-byte-aligned rows (the training path): tensor
//   cores through `mma.sync.m16n8k16` (bf16 in, fp32 accumulate). 4 warps per
//   CTA, 64-row tiles of bf16 in shared memory (rows padded by 16 bytes so
//   fragment loads are conflict-free). The dkv pass computes the TRANSPOSED
//   products S^T = K Q^T and dP^T = V dO^T, so each warp owns 16 key rows and
//   P^T / dS^T come out of the accumulators already in the A-operand layout
//   of dV += P^T dO and dK += dS^T Q; the B operands of those two (dO, Q,
//   stored query-major) come from `ldmatrix.trans`. The dq pass mirrors the
//   forward: each warp owns 16 query rows, dS goes from its accumulators
//   into the A operand of dQ += dS K, K through `ldmatrix.trans`. The dkv
//   warp holds dK and dV (2 x 64 fp32 a thread) for the whole loop, so it
//   walks each query tile in halves of 32 to keep the logits tiles small.
//   Loads are synchronous (no cp.async/TMA pipeline); wgmma + TMA is the
//   next step toward the bound.
// * everything else (fp32, head_dim 256, unaligned bf16 rows): fp32 FMAs on
//   the CUDA cores, 256 threads per CTA, 32-row tiles staged as fp32 in
//   shared memory (four tiles of 32 x 257 floats fit at head_dim 256); p and
//   ds pass through shared memory into the second products. At head_dim 256
//   the tensor-core layout above would need 2 x 128 fp32 accumulators a
//   thread, past the register file.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
typedef __nv_bfloat16 bf16;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;   // (B, H, Sq)
  float* di;          // (B, H, Sq), written by the di pass
  const int* q_seg;   // (B, Sq) contiguous, or null
  const int* kv_seg;  // (B, Sk) contiguous, or null
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int B, H, Sq, Sk;
  float sm_scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, back in fp32 (Pallas's `.astype(do.dtype)`)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// ------------------------------------------------------------------ di pass
constexpr int kDiThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kDiThreads) di_kernel(const BwdParams p) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kDiThreads / 32) + (threadIdx.x >> 5);
  const long long total = (long long)p.B * p.H * p.Sq;
  if (row >= total) return;
  const int s = (int)(row % p.Sq);
  const int h = (int)((row / p.Sq) % p.H);
  const int b = (int)(row / ((long long)p.Sq * p.H));
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + (long long)s * p.o_ss + h * p.o_sh;
  const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + (long long)s * p.do_ss + h * p.do_sh;
  float acc = 0.f;
#pragma unroll
  for (int i = lane; i < D; i += 32) acc = fmaf(to_f32(o[i]), to_f32(d[i]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.di[row] = acc;  // row = (b * H + h) * Sq + s
}

// ---------------------------------------------------------- CUDA-core path
constexpr int kCBlock = 32;    // query and key tile rows
constexpr int kCThreads = 256;  // 32 rows x 8 column groups
constexpr int kCPad = kCBlock + 1;

template <int D>
constexpr size_t c_smem_bytes() {
  // four fp32 tiles (rows padded by one float), two 32 x 33 probability /
  // ds tiles, lse and di of a query tile, and one tile of segment ids
  return sizeof(float) * (size_t)(4 * kCBlock * (D + 1) + 2 * kCBlock * kCPad + 2 * kCBlock) +
         sizeof(int) * kCBlock;
}

template <typename T, int D>
__device__ __forceinline__ void c_load_tile(float* dst, const T* src, long long row_stride) {
  for (int idx = threadIdx.x; idx < kCBlock * D; idx += kCThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * (D + 1) + d] = to_f32(src[(long long)r * row_stride + d]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kCThreads) dq_kernel(const BwdParams p) {
  constexpr int kOut = D / 8;  // dQ columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kCBlock * (D + 1);
  float* k_s = do_s + kCBlock * (D + 1);
  float* v_s = k_s + kCBlock * (D + 1);
  float* ds_s = v_s + kCBlock * (D + 1);
  int* kvseg_s = reinterpret_cast<int*>(ds_s + kCBlock * kCPad);

  const int n_qtiles = p.Sq / kCBlock;
  const int qt = n_qtiles - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kCBlock;
  const int ty = threadIdx.x >> 3;  // query row in the tile
  const int tx = threadIdx.x & 7;   // key / output column group

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + (long long)q0 * p.q_ss + h * p.q_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + (long long)q0 * p.do_ss + h * p.do_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  c_load_tile<T, D>(q_s, qg, p.q_ss);
  c_load_tile<T, D>(do_s, dog, p.do_ss);

  const int row = q0 + ty;
  const long long stat = ((long long)b * p.H + h) * p.Sq + row;
  const float lse = p.lse[stat];
  const float di = p.di[stat];
  const int qseg = p.q_seg ? p.q_seg[(long long)b * p.Sq + row] : 0;

  float acc[kOut];
#pragma unroll
  for (int c = 0; c < kOut; ++c) acc[c] = 0.f;

  const int n_ktiles_all = p.Sk / kCBlock;
  const int n_ktiles =
      p.causal ? min(n_ktiles_all, (q0 + kCBlock - 1) / kCBlock + 1) : n_ktiles_all;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kCBlock;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    c_load_tile<T, D>(k_s, kg + (long long)k0 * p.k_ss, p.k_ss);
    c_load_tile<T, D>(v_s, vg + (long long)k0 * p.v_ss, p.v_ss);
    if (p.kv_seg != nullptr && threadIdx.x < kCBlock) {
      kvseg_s[threadIdx.x] = p.kv_seg[(long long)b * p.Sk + k0 + threadIdx.x];
    }
    __syncthreads();

    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = q_s[ty * (D + 1) + d];
      const float dov = do_s[ty * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = fmaf(qv, k_s[(tx + 8 * j) * (D + 1) + d], s[j]);
        dp[j] = fmaf(dov, v_s[(tx + 8 * j) * (D + 1) + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 8 * j;
      bool keep = true;
      if (p.kv_seg != nullptr) keep = (qseg == kvseg_s[c]);
      if (p.causal) keep = keep && (k0 + c <= row);
      const float pij = expf(s[j] * p.sm_scale + (keep ? 0.f : kMaskValue) - lse);
      ds_s[ty * kCPad + c] = round_to<T>((dp[j] - di) * pij * p.sm_scale);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kCBlock; ++kk) {
      const float dsv = ds_s[ty * kCPad + kk];
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[c] = fmaf(dsv, k_s[kk * (D + 1) + tx + 8 * c], acc[c]);
    }
  }

  T* dqg = static_cast<T*>(p.dq) + b * p.dq_sb + (long long)row * p.dq_ss + h * p.dq_sh;
#pragma unroll
  for (int c = 0; c < kOut; ++c) dqg[tx + 8 * c] = from_f32<T>(acc[c]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kCThreads) dkv_kernel(const BwdParams p) {
  constexpr int kOut = D / 8;  // dK / dV columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kCBlock * (D + 1);
  float* q_s = v_s + kCBlock * (D + 1);
  float* do_s = q_s + kCBlock * (D + 1);
  float* p_s = do_s + kCBlock * (D + 1);
  float* ds_s = p_s + kCBlock * kCPad;
  float* lse_s = ds_s + kCBlock * kCPad;
  float* di_s = lse_s + kCBlock;
  int* qseg_s = reinterpret_cast<int*>(di_s + kCBlock);

  const int kt = blockIdx.x;  // low key tiles see the most query tiles
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kCBlock;
  const int ty = threadIdx.x >> 3;  // key row in the tile
  const int tx = threadIdx.x & 7;   // query / output column group
  const int key = k0 + ty;

  c_load_tile<T, D>(k_s, static_cast<const T*>(p.k) + b * p.k_sb + (long long)k0 * p.k_ss +
                             h * p.k_sh, p.k_ss);
  c_load_tile<T, D>(v_s, static_cast<const T*>(p.v) + b * p.v_sb + (long long)k0 * p.v_ss +
                             h * p.v_sh, p.v_ss);
  const int kvseg = p.kv_seg ? p.kv_seg[(long long)b * p.Sk + key] : 0;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long stat0 = ((long long)b * p.H + h) * p.Sq;

  float dk[kOut], dv[kOut];
#pragma unroll
  for (int c = 0; c < kOut; ++c) dk[c] = dv[c] = 0.f;

  const int n_qtiles = p.Sq / kCBlock;
  for (int qt = p.causal ? k0 / kCBlock : 0; qt < n_qtiles; ++qt) {
    const int q0 = qt * kCBlock;
    __syncthreads();  // the previous tile's Q, dO, p and ds are no longer read
    c_load_tile<T, D>(q_s, qg + (long long)q0 * p.q_ss, p.q_ss);
    c_load_tile<T, D>(do_s, dog + (long long)q0 * p.do_ss, p.do_ss);
    if (threadIdx.x < kCBlock) {
      lse_s[threadIdx.x] = p.lse[stat0 + q0 + threadIdx.x];
      di_s[threadIdx.x] = p.di[stat0 + q0 + threadIdx.x];
      if (p.q_seg != nullptr) qseg_s[threadIdx.x] = p.q_seg[(long long)b * p.Sq + q0 + threadIdx.x];
    }
    __syncthreads();

    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kv = k_s[ty * (D + 1) + d];
      const float vv = v_s[ty * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = fmaf(kv, q_s[(tx + 8 * j) * (D + 1) + d], s[j]);
        dp[j] = fmaf(vv, do_s[(tx + 8 * j) * (D + 1) + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 8 * j;
      bool keep = true;
      if (p.q_seg != nullptr) keep = (qseg_s[c] == kvseg);
      if (p.causal) keep = keep && (key <= q0 + c);
      const float pij = expf(s[j] * p.sm_scale + (keep ? 0.f : kMaskValue) - lse_s[c]);
      p_s[ty * kCPad + c] = round_to<T>(pij);
      ds_s[ty * kCPad + c] = round_to<T>((dp[j] - di_s[c]) * pij * p.sm_scale);
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kCBlock; ++qq) {
      const float pv = p_s[ty * kCPad + qq];
      const float dsv = ds_s[ty * kCPad + qq];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        dv[c] = fmaf(pv, do_s[qq * (D + 1) + tx + 8 * c], dv[c]);
        dk[c] = fmaf(dsv, q_s[qq * (D + 1) + tx + 8 * c], dk[c]);
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.dk_sb + (long long)key * p.dk_ss + h * p.dk_sh;
  T* dvg = static_cast<T*>(p.dv) + b * p.dv_sb + (long long)key * p.dv_ss + h * p.dv_sh;
#pragma unroll
  for (int c = 0; c < kOut; ++c) {
    dkg[tx + 8 * c] = from_f32<T>(dk[c]);
    dvg[tx + 8 * c] = from_f32<T>(dv[c]);
  }
}

// -------------------------------------------------------- tensor-core path
constexpr int kBlock = 64;        // query and key tile rows
constexpr int kMmaThreads = 128;  // 4 warps x 16 rows
constexpr int kMmaD = 128;
constexpr int kStride = kMmaD + 8;  // bf16 per smem row, +16 bytes

constexpr size_t mma_smem_bytes() {
  // four bf16 tiles, plus lse, di and segment ids of one tile
  return sizeof(bf16) * (size_t)(4 * kBlock * kStride) + sizeof(float) * 2 * kBlock +
         sizeof(int) * kBlock;
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const bf16* ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, long long row_stride) {
  // kBlock rows x kMmaD, 16 bytes per thread per step (rows are 16-byte aligned)
  constexpr int kVecs = kMmaD / 8;
  for (int idx = threadIdx.x; idx < kBlock * kVecs; idx += kMmaThreads) {
    const int r = idx / kVecs;
    const int c = (idx - r * kVecs) * 8;
    *reinterpret_cast<uint4*>(dst + r * kStride + c) =
        *reinterpret_cast<const uint4*>(src + (long long)r * row_stride + c);
  }
}

// acc (16 x 8n tiles of the warp's rows) += A (16 x 16 k-chunk, registers) .
// B, where B's 16 k-rows start at `rows` in a row-major [k][d] smem tile
__device__ __forceinline__ void mma_rows_trans(float (*acc)[4], const uint32_t* a,
                                               const bf16* rows, int lane) {
  const bf16* r = rows + (lane & 15) * kStride;
#pragma unroll
  for (int n = 0; n < kMmaD / 8; ++n) {
    uint32_t bfrag[2];
    ldmatrix_x2_trans(bfrag, r + n * 8);
    mma_16816(acc[n], a, bfrag);
  }
}

// s (16 rows x 8*NT cols) += A_rows . B_rows^T over kMmaD, A's 16 rows at
// a_rows (the warp's), B's 8*NT rows at b_rows: both row-major [row][d]
template <int NT>
__device__ __forceinline__ void mma_abt(float (*s)[4], const bf16* a_rows, const bf16* b_rows,
                                        int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < kMmaD / 16; ++kk) {
    const bf16* pa = a_rows + g * kStride + kk * 16 + t4 * 2;
    const uint32_t a[4] = {lds32(pa), lds32(pa + 8 * kStride), lds32(pa + 8),
                           lds32(pa + 8 * kStride + 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* pb = b_rows + (j * 8 + g) * kStride + kk * 16 + t4 * 2;
      const uint32_t bfrag[2] = {lds32(pb), lds32(pb + 8)};
      mma_16816(s[j], a, bfrag);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads) dq_mma_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBlock * kStride;
  bf16* k_s = do_s + kBlock * kStride;
  bf16* v_s = k_s + kBlock * kStride;
  int* kvseg_s = reinterpret_cast<int*>(v_s + kBlock * kStride);

  const int n_qtiles = p.Sq / kBlock;
  const int qt = n_qtiles - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBlock;
  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16;  // the warp's first row in the tile
  const int g = lane >> 2;
  const int t4 = lane & 3;

  load_tile_bf16(q_s, static_cast<const bf16*>(p.q) + b * p.q_sb + (long long)q0 * p.q_ss +
                          h * p.q_sh, p.q_ss);
  load_tile_bf16(do_s, static_cast<const bf16*>(p.dout) + b * p.do_sb +
                           (long long)q0 * p.do_ss + h * p.do_sh, p.do_ss);
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  const int row0 = q0 + wrow + g;  // the two query rows this thread holds
  const int row1 = row0 + 8;
  const long long stat = ((long long)b * p.H + h) * p.Sq;
  const float lse0 = p.lse[stat + row0], lse1 = p.lse[stat + row1];
  const float di0 = p.di[stat + row0], di1 = p.di[stat + row1];
  int qseg0 = 0, qseg1 = 0;
  if (p.q_seg != nullptr) {
    qseg0 = p.q_seg[(long long)b * p.Sq + row0];
    qseg1 = p.q_seg[(long long)b * p.Sq + row1];
  }

  float acc[kMmaD / 8][4];
#pragma unroll
  for (int n = 0; n < kMmaD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_ktiles_all = p.Sk / kBlock;
  const int n_ktiles =
      p.causal ? min(n_ktiles_all, (q0 + kBlock - 1) / kBlock + 1) : n_ktiles_all;
  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile_bf16(k_s, kg + (long long)k0 * p.k_ss, p.k_ss);
    load_tile_bf16(v_s, vg + (long long)k0 * p.v_ss, p.v_ss);
    if (p.kv_seg != nullptr && threadIdx.x < kBlock) {
      kvseg_s[threadIdx.x] = p.kv_seg[(long long)b * p.Sk + k0 + threadIdx.x];
    }
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_abt<8>(s, q_s + wrow * kStride, k_s, g, t4);    // S = Q K^T
    mma_abt<8>(dp, do_s + wrow * kStride, v_s, g, t4);  // dP = dO V^T

#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + t4 * 2 + e;
        bool keep0 = true, keep1 = true;
        if (p.kv_seg != nullptr) {
          keep0 = qseg0 == kvseg_s[c];
          keep1 = qseg1 == kvseg_s[c];
        }
        if (p.causal) {
          keep0 = keep0 && (k0 + c <= row0);
          keep1 = keep1 && (k0 + c <= row1);
        }
        const float p0 = expf(s[j][e] * p.sm_scale + (keep0 ? 0.f : kMaskValue) - lse0);
        const float p1 = expf(s[j][2 + e] * p.sm_scale + (keep1 ? 0.f : kMaskValue) - lse1);
        s[j][e] = (dp[j][e] - di0) * p0 * p.sm_scale;  // s now holds dS
        s[j][2 + e] = (dp[j][2 + e] - di1) * p1 * p.sm_scale;
      }
    }

    // dQ += dS K: dS's accumulator layout is the A operand layout
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_rows_trans(acc, a, k_s + kk * 16 * kStride, lane);
    }
  }

  bf16* dqg = static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int n = 0; n < kMmaD / 8; ++n) {
    const int d = n * 8 + t4 * 2;
    *reinterpret_cast<__nv_bfloat162*>(dqg + (long long)row0 * p.dq_ss + d) =
        __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dqg + (long long)row1 * p.dq_ss + d) =
        __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

__global__ void __launch_bounds__(kMmaThreads) dkv_mma_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBlock * kStride;
  bf16* q_s = v_s + kBlock * kStride;
  bf16* do_s = q_s + kBlock * kStride;
  float* lse_s = reinterpret_cast<float*>(do_s + kBlock * kStride);
  float* di_s = lse_s + kBlock;
  int* qseg_s = reinterpret_cast<int*>(di_s + kBlock);

  const int kt = blockIdx.x;  // low key tiles see the most query tiles
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kBlock;
  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16;  // the warp's first key row in the tile
  const int g = lane >> 2;
  const int t4 = lane & 3;

  load_tile_bf16(k_s, static_cast<const bf16*>(p.k) + b * p.k_sb + (long long)k0 * p.k_ss +
                          h * p.k_sh, p.k_ss);
  load_tile_bf16(v_s, static_cast<const bf16*>(p.v) + b * p.v_sb + (long long)k0 * p.v_ss +
                          h * p.v_sh, p.v_ss);
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dog = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long stat0 = ((long long)b * p.H + h) * p.Sq;

  const int key0 = k0 + wrow + g;  // the two key rows this thread holds
  const int key1 = key0 + 8;
  int kvseg0 = 0, kvseg1 = 0;
  if (p.kv_seg != nullptr) {
    kvseg0 = p.kv_seg[(long long)b * p.Sk + key0];
    kvseg1 = p.kv_seg[(long long)b * p.Sk + key1];
  }

  float dk[kMmaD / 8][4], dv[kMmaD / 8][4];
#pragma unroll
  for (int n = 0; n < kMmaD / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  const int n_qtiles = p.Sq / kBlock;
  for (int qt = p.causal ? k0 / kBlock : 0; qt < n_qtiles; ++qt) {
    const int q0 = qt * kBlock;
    __syncthreads();  // the previous tile's Q and dO are no longer read
    load_tile_bf16(q_s, qg + (long long)q0 * p.q_ss, p.q_ss);
    load_tile_bf16(do_s, dog + (long long)q0 * p.do_ss, p.do_ss);
    if (threadIdx.x < kBlock) {
      lse_s[threadIdx.x] = p.lse[stat0 + q0 + threadIdx.x];
      di_s[threadIdx.x] = p.di[stat0 + q0 + threadIdx.x];
      if (p.q_seg != nullptr) qseg_s[threadIdx.x] = p.q_seg[(long long)b * p.Sq + q0 + threadIdx.x];
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qh = half * 32;  // first query of this half in the tile
      float st[4][4], dpt[4][4];  // S^T and dP^T: 16 keys x 32 queries
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
      mma_abt<4>(st, k_s + wrow * kStride, q_s + qh * kStride, g, t4);    // K Q^T
      mma_abt<4>(dpt, v_s + wrow * kStride, do_s + qh * kStride, g, t4);  // V dO^T

#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = qh + j * 8 + t4 * 2 + e;  // query in the tile
          bool keep0 = true, keep1 = true;
          if (p.q_seg != nullptr) {
            keep0 = kvseg0 == qseg_s[c];
            keep1 = kvseg1 == qseg_s[c];
          }
          if (p.causal) {
            keep0 = keep0 && (key0 <= q0 + c);
            keep1 = keep1 && (key1 <= q0 + c);
          }
          const float lse = lse_s[c], di = di_s[c];
          const float p0 = expf(st[j][e] * p.sm_scale + (keep0 ? 0.f : kMaskValue) - lse);
          const float p1 = expf(st[j][2 + e] * p.sm_scale + (keep1 ? 0.f : kMaskValue) - lse);
          st[j][e] = p0;  // st now holds P^T, dpt dS^T
          st[j][2 + e] = p1;
          dpt[j][e] = (dpt[j][e] - di) * p0 * p.sm_scale;
          dpt[j][2 + e] = (dpt[j][2 + e] - di) * p1 * p.sm_scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q, 16 queries of k-depth at a time
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t ap[4] = {pack_bf16x2(st[2 * kk][0], st[2 * kk][1]),
                                pack_bf16x2(st[2 * kk][2], st[2 * kk][3]),
                                pack_bf16x2(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                pack_bf16x2(st[2 * kk + 1][2], st[2 * kk + 1][3])};
        mma_rows_trans(dv, ap, do_s + (qh + kk * 16) * kStride, lane);
        const uint32_t as[4] = {pack_bf16x2(dpt[2 * kk][0], dpt[2 * kk][1]),
                                pack_bf16x2(dpt[2 * kk][2], dpt[2 * kk][3]),
                                pack_bf16x2(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                pack_bf16x2(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
        mma_rows_trans(dk, as, q_s + (qh + kk * 16) * kStride, lane);
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh;
  bf16* dvg = static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int n = 0; n < kMmaD / 8; ++n) {
    const int d = n * 8 + t4 * 2;
    *reinterpret_cast<__nv_bfloat162*>(dkg + (long long)key0 * p.dk_ss + d) =
        __floats2bfloat162_rn(dk[n][0], dk[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dkg + (long long)key1 * p.dk_ss + d) =
        __floats2bfloat162_rn(dk[n][2], dk[n][3]);
    *reinterpret_cast<__nv_bfloat162*>(dvg + (long long)key0 * p.dv_ss + d) =
        __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(dvg + (long long)key1 * p.dv_ss + d) =
        __floats2bfloat162_rn(dv[n][2], dv[n][3]);
  }
}

// --------------------------------------------------------------- launching
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
cudaError_t launch_di(const BwdParams& p, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.H * p.Sq;
  const int per_block = kDiThreads / 32;
  di_kernel<T, D><<<(unsigned)((rows + per_block - 1) / per_block), kDiThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_cuda_core(const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = launch_di<T, D>(p, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = c_smem_bytes<D>();
  static bool smem_attr_set = false;  // one per instantiation
  if (!smem_attr_set) {
    if ((err = allow_smem(dkv_kernel<T, D>, smem)) != cudaSuccess) return err;
    if ((err = allow_smem(dq_kernel<T, D>, smem)) != cudaSuccess) return err;
    smem_attr_set = true;
  }
  dkv_kernel<T, D><<<dim3(p.Sk / kCBlock, p.H, p.B), kCThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<T, D><<<dim3(p.Sq / kCBlock, p.H, p.B), kCThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_mma(const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = launch_di<bf16, kMmaD>(p, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = mma_smem_bytes();
  static bool smem_attr_set = false;
  if (!smem_attr_set) {
    if ((err = allow_smem(dkv_mma_kernel, smem)) != cudaSuccess) return err;
    if ((err = allow_smem(dq_mma_kernel, smem)) != cudaSuccess) return err;
    smem_attr_set = true;
  }
  dkv_mma_kernel<<<dim3(p.Sk / kBlock, p.H, p.B), kMmaThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_mma_kernel<<<dim3(p.Sq / kBlock, p.H, p.B), kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

bool rows_16b_aligned(const void* ptr, long long sb, long long ss, long long sh) {
  // 16-byte vector loads of bf16 rows: base and every row start aligned
  return (reinterpret_cast<uintptr_t>(ptr) % 16 == 0) && sb % 8 == 0 && ss % 8 == 0 &&
         sh % 8 == 0;
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t value on a CUDA failure, or -1 for an
// argument the kernel does not take (the Python wrapper checks these first).
// strides: 24 element strides, (batch, seq, head) for q, k, v, out, dout, dq,
// dk, dv in turn. di: (B, H, Sq) fp32 scratch. dtype: 0 = float32, 1 = bfloat16.
int galv_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, void* dq, void* dk, void* dv,
                        float* di, const int* q_seg, const int* kv_seg,
                        const long long* strides, int B, int H, int Sq, int Sk, int D,
                        int dtype, float sm_scale, int causal, int device, void* stream) {
  if (Sq % kBlock != 0 || Sk % kBlock != 0 || B < 1 || H < 1 || Sq < 1 || Sk < 1) return -1;
  if (D != 128 && D != 256) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = lse; p.di = di;
  p.q_seg = q_seg; p.kv_seg = kv_seg;
  long long* dst[24] = {&p.q_sb,  &p.q_ss,  &p.q_sh,  &p.k_sb,  &p.k_ss,  &p.k_sh,
                        &p.v_sb,  &p.v_ss,  &p.v_sh,  &p.o_sb,  &p.o_ss,  &p.o_sh,
                        &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb, &p.dq_ss, &p.dq_sh,
                        &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh};
  for (int i = 0; i < 24; ++i) *dst[i] = strides[i];
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.sm_scale = sm_scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  bool aligned = true;
  for (int i = 0; i < 8; ++i) {
    aligned = aligned && rows_16b_aligned(ptrs[i], strides[3 * i], strides[3 * i + 1],
                                          strides[3 * i + 2]);
  }
  if (dtype == 1 && D == kMmaD && aligned) {
    err = launch_mma(p, s);
  } else if (dtype == 1) {
    err = D == 128 ? launch_cuda_core<bf16, 128>(p, s) : launch_cuda_core<bf16, 256>(p, s);
  } else {
    err = D == 128 ? launch_cuda_core<float, 128>(p, s) : launch_cuda_core<float, 256>(p, s);
  }
  return (int)err;
}

const char* galv_cuda_error_string(int code) {
  if (code == -1) return "argument not supported by the flash-attention backward kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
