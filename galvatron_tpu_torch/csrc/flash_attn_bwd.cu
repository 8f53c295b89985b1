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
//  2. dkv: one CTA per key tile keeps its dK and dV accumulators for the
//     whole run and loops over the query tiles from the causal diagonal to
//     the end (the Pallas grid's sequential q axis becomes a loop inside the
//     block).
//  3. dq: one CTA per query tile loops over the key tiles up to the causal
//     diagonal, accumulating dQ.
// Both dkv and dq recompute S = q k^T and dP = dout v^T, so the design does
// 14 * hd FLOP per admitted pair against the 10 * hd the bound counts: its
// ceiling is ~71% of the bound, which keeps counting 10 * hd, the work the
// function needs.
//
// Two routes behind one entry point; the Python wrapper picks the route
// (`flash_route`) and this file refuses (-1) a route that does not take the
// arguments:
//
// * route 2, "wgmma" (bf16, head_dim 128, every base 16-byte aligned and
//   every (batch, seq, head) stride a multiple of 8 elements: TMA's rule;
//   the training path): the forward's Hopper design (`sm90.cuh`). Each pass
//   runs one CTA of three warpgroups per 128-row tile: a producer warp
//   (registers cut to 24) loads the CTA's resident tile pair once and
//   streams 64-row tiles of the other pair through a 3-stage TMA ring with
//   full/empty mbarriers (one 64-row-box tensor map per input, shared by
//   both passes); two consumer warpgroups (240 registers each) own 64 rows
//   of the resident tile and run every product as `wgmma`. In the
//   dkv pass the products are transposed, S^T = K Q^T and dP^T = V dO^T,
//   so P^T and dS^T leave the accumulators already in the A-register layout
//   of dV += P^T dO and dK += dS^T Q, with dO and Q read as MN-major B
//   operands; dK and dV (2 x 64 fp32 a thread) stay in registers for the
//   whole loop, which is what the 240-register budget is for. The dq pass
//   takes dS from its accumulators into dQ += dS K, K as MN-major B; it
//   issues S and dP of the next tile while dQ += dS K is in flight, and
//   its two warpgroups take turns issuing (ping-pong on named barriers).
//   The dkv pass does neither: with dK and dV resident, the registers that
//   would hold a second tile's operands are not there (ping-pong alone
//   made ptxas spill). Score tiles that no mask touches take one FFMA and
//   one EX2 per element. A warpgroup whose 64 rows lie past S
//   (S % 128 == 64) idles, and the producer loads only the owned half.
// * route 0, "cuda_core" (everything else: fp32, head_dim 256, unaligned
//   bf16 rows): fp32 FMAs on the CUDA cores, 256 threads per CTA, 32-row
//   tiles staged as fp32 in shared memory (four tiles of 32 x 257 floats fit
//   at head_dim 256); p and ds pass through shared memory into the second
//   products. At head_dim 256 dK and dV alone would be 2 x 128 fp32 a
//   thread, past the register file.
// Tiles are issued heaviest-first so the causal triangle balances over SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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

// ---------------------------------------------------------------- wgmma path
constexpr int kWgTile = 128;   // keys (dkv) or queries (dq) per CTA: two warpgroups of 64
constexpr int kWgStep = 64;    // queries (dkv) or keys (dq) per pipeline stage
constexpr int kWgStages = 3;
constexpr int kWgThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kBoxCols = 64;     // head_dim columns per TMA box: 128 bytes, the swizzle width
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kTileBoxBytes = kWgTile * kBoxCols * 2;  // one box of the resident tile
constexpr uint32_t kStepBoxBytes = kWgStep * kBoxCols * 2;  // one box of a streamed tile

struct BwdMaps {
  CUtensorMap q, k, v, dout;  // boxes of 64 columns x 64 rows
};

struct DkvSmem {
  bf16 k[2][kWgTile * kBoxCols];  // 16 KB per box, 1024-byte aligned
  bf16 v[2][kWgTile * kBoxCols];
  bf16 q[kWgStages][2][kWgStep * kBoxCols];
  bf16 dout[kWgStages][2][kWgStep * kBoxCols];
  float lse[kWgStages][kWgStep];
  float di[kWgStages][kWgStep];
  int qseg[kWgStages][kWgStep];
  uint64_t tile_full;
  uint64_t full[kWgStages];
  uint64_t empty[kWgStages];
};

struct DqSmem {
  bf16 q[2][kWgTile * kBoxCols];
  bf16 dout[2][kWgTile * kBoxCols];
  bf16 k[kWgStages][2][kWgStep * kBoxCols];
  bf16 v[kWgStages][2][kWgStep * kBoxCols];
  int kvseg[kWgStages][kWgStep];
  uint64_t tile_full;
  uint64_t full[kWgStages];
  uint64_t empty[kWgStages];
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename Smem>
__device__ __forceinline__ Smem& aligned_smem(unsigned char* raw) {
  // the 128B swizzle wants 1024-byte aligned boxes; one spare KB is allocated
  return *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void init_ring(uint64_t* tile_full, uint64_t* full, uint64_t* empty,
                                          int n_consumers) {
  if (threadIdx.x == 0) {
    sm90::mbar_init(tile_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      sm90::mbar_init(&full[s], 32);                 // every producer lane
      sm90::mbar_init(&empty[s], 4 * n_consumers);  // every consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();
}

// rows [row, row + box rows) of one (head, batch): both 64-column boxes
__device__ __forceinline__ void tma_rows(bf16* box0, bf16* box1, const CUtensorMap* map,
                                         uint64_t* bar, int row, int h, int b) {
  sm90::tma_load_4d(box0, map, bar, 0, row, h, b);
  sm90::tma_load_4d(box1, map, bar, kBoxCols, row, h, b);
}

// a resident 128-row tile: each 64-column box as two 64-row loads, the
// second 8 KB after the first, which is the layout of one 128-row box; the
// second half only where a consumer owns it (`halves` == 2)
__device__ __forceinline__ void tma_tile(bf16* box0, bf16* box1, const CUtensorMap* map,
                                         uint64_t* bar, int row, int h, int b, int halves) {
  tma_rows(box0, box1, map, bar, row, h, b);
  if (halves == 2) {
    tma_rows(box0 + kWgStep * kBoxCols, box1 + kWgStep * kBoxCols, map, bar, row + kWgStep, h, b);
  }
}

// p = exp(s * scale + mask - lse) in base 2. Unmasked: one FFMA and EX2
// with the scale and lse folded into log2 units. Masked: the logit is the
// mask value itself (s * scale + mask rounds to it in fp32), and the
// difference is taken in natural units before the conversion, so a row whose
// every key is masked (lse ~ the mask value) still gets exp(-log n), not NaN.
template <bool kMasked>
__device__ __forceinline__ float bwd_p(float s, bool keep, float scale, float lse) {
  if (kMasked) return sm90::exp2_approx(((keep ? s * scale : kMaskValue) - lse) * kLog2e);
  return sm90::exp2_approx(fmaf(s, scale * kLog2e, -lse * kLog2e));
}

struct DkvRows {
  int key0, key1;      // the two keys a thread holds
  int kvseg0, kvseg1;  // their segment ids (0 without segment ids)
  int t4;              // column pair within an 8-column group
  int q0;              // the query tile's first query
};

// P^T and dS^T of one tile (keys x 64 queries) from S^T and dP^T, packed as
// the A operands of dV += P^T dO and dK += dS^T Q: p rounded to bf16 before
// dV, ds = p (dp - di) scale rounded to bf16 before dK.
template <bool kMasked>
__device__ __forceinline__ void dkv_scores(const float (&st)[32], const float (&dpt)[32],
                                           const float* lse_s, const float* di_s,
                                           const int* qseg_s, const BwdParams& p,
                                           const DkvRows& r, uint32_t (&pa)[4][4],
                                           uint32_t (&sa)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cj = 8 * j + 2 * r.t4;  // query of the tile, and cj + 1
    const float2 lse = *reinterpret_cast<const float2*>(lse_s + cj);
    const float2 di = *reinterpret_cast<const float2*>(di_s + cj);
    float pr[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool keep = true;
      if (kMasked) {
        const int qi = cj + (e & 1);
        keep = !p.causal || (e < 2 ? r.key0 : r.key1) <= r.q0 + qi;
        if (p.q_seg != nullptr) keep = keep && (e < 2 ? r.kvseg0 : r.kvseg1) == qseg_s[qi];
      }
      pr[e] = bwd_p<kMasked>(st[4 * j + e], keep, p.sm_scale, (e & 1) ? lse.y : lse.x);
      ds[e] = (dpt[4 * j + e] - ((e & 1) ? di.y : di.x)) * pr[e] * p.sm_scale;
    }
    pa[j >> 1][(j & 1) * 2] = pack_bf16x2(pr[0], pr[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(pr[2], pr[3]);
    sa[j >> 1][(j & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
    sa[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
  }
}

struct DqRows {
  int row0, row1;      // the two queries a thread holds
  float lse0, lse1;
  float di0, di1;
  int qseg0, qseg1;    // their segment ids (0 without segment ids)
  int t4;              // column pair within an 8-column group
};

// dS of one tile (64 queries x 64 keys) from S and dP, rounded to bf16 and
// packed as the A operand of dQ += dS K
template <bool kMasked>
__device__ __forceinline__ void dq_scores(const float (&sc)[32], const float (&dp)[32],
                                          const int* kvseg_s, const BwdParams& p, int k0,
                                          const DqRows& r, uint32_t (&sa)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool keep = true;
      if (kMasked) {
        const int cj = 8 * j + 2 * r.t4 + (e & 1);
        keep = !p.causal || k0 + cj <= (e < 2 ? r.row0 : r.row1);
        if (p.kv_seg != nullptr) keep = keep && (e < 2 ? r.qseg0 : r.qseg1) == kvseg_s[cj];
      }
      const float pr = bwd_p<kMasked>(sc[4 * j + e], keep, p.sm_scale, e < 2 ? r.lse0 : r.lse1);
      ds[e] = (dp[4 * j + e] - (e < 2 ? r.di0 : r.di1)) * pr * p.sm_scale;
    }
    sa[j >> 1][(j & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
    sa[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
  }
}

// acc (64 x 64) = A (64 rows of the resident tile) . B^T (64 rows of a
// streamed tile) over head_dim 128: both K-major, two boxes of four
// 16-column slices each
__device__ __forceinline__ void k_major_products(float (&acc)[32], uint32_t a_rows,
                                                 uint32_t b_rows) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t a_off = (kk >> 2) * kTileBoxBytes + (kk & 3) * 32;
    const uint32_t b_off = (kk >> 2) * kStepBoxBytes + (kk & 3) * 32;
    sm90::wgmma_m64n64k16_ss(acc, sm90::desc_k_major(a_rows + a_off),
                             sm90::desc_k_major(b_rows + b_off), kk > 0);
  }
}

// acc (64 x 128) += A (64 x 64, registers, four 16-wide slices) . B (64 rows
// of a streamed tile x head_dim 128, MN-major)
__device__ __forceinline__ void rs_products(float (&acc)[64], const uint32_t (&a)[4][4],
                                            uint32_t b_rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    sm90::wgmma_m64n128k16_rs_mn(acc, a[kk], sm90::desc_mn_major(b_rows + kk * 2048, kStepBoxBytes));
  }
}

// An accumulator fragment (rows row0 and row1 of a 64 x 128 tile) to bf16
// rows `ss` elements apart, one column pair of each 8-column group at a
// time; the fence keeps the compiler from converting every pair before the
// first store, which would take ~64 more registers than the loop needs.
__device__ __forceinline__ void store_rows(bf16* base, long long ss, int row0, int row1, int t4,
                                           float (&acc)[64]) {
  bf16* r0 = base + (long long)row0 * ss + 2 * t4;
  bf16* r1 = base + (long long)row1 * ss + 2 * t4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * j) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(r1 + 8 * j) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    sm90::fence_regs(acc);
  }
}

// Pass 2, dK and dV. One CTA per (128-key tile, head, batch); consumer
// warpgroup w owns keys k0 + 64w .. +63 and keeps their dK and dV (2 x 64
// fp32 a thread) in registers while the producer streams 64-query tiles of
// Q and dO (with their lse, di and segment ids) from the causal diagonal on.
// Per tile: S^T = K Q^T and dP^T = V dO^T (wgmma, both operands K-major in
// shared memory), P^T and dS^T from the accumulators into A-register
// fragments (p rounded to bf16 before dV, ds before dK), then dV += P^T dO
// and dK += dS^T Q (wgmma, dO and Q as MN-major B).
__global__ void __launch_bounds__(kWgThreads, 1)
    dkv_wgmma_kernel(const BwdParams p, const __grid_constant__ BwdMaps maps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem& sm = aligned_smem<DkvSmem>(smem_raw);
  const int k0 = blockIdx.x * kWgTile;  // low key tiles see the most query tiles
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_consumers = k0 + 64 < p.Sk ? 2 : 1;  // S % 128 == 64: the last tile's half
  const int qt0 = p.causal ? k0 / kWgStep : 0;
  const int n_steps = p.Sq / kWgStep - qt0;
  const int wg = threadIdx.x / 128;
  init_ring(&sm.tile_full, sm.full, sm.empty, n_consumers);

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    sm90::regs_dealloc<24>();
    if (threadIdx.x >= 2 * 128 + 32) return;  // one warp issues everything
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&sm.tile_full, 4 * n_consumers * kStepBoxBytes);
      tma_tile(sm.k[0], sm.k[1], &maps.k, &sm.tile_full, k0, h, b, n_consumers);
      tma_tile(sm.v[0], sm.v[1], &maps.v, &sm.tile_full, k0, h, b, n_consumers);
    }
    const long long stat0 = ((long long)b * p.H + h) * p.Sq;
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % kWgStages;
      const int q0 = (qt0 + it) * kWgStep;
      sm90::mbar_wait(&sm.empty[s], ((it / kWgStages) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < kWgStep / 32; ++i) {
        const int r = lane + 32 * i;
        sm.lse[s][r] = p.lse[stat0 + q0 + r];
        sm.di[s][r] = p.di[stat0 + q0 + r];
        if (p.q_seg != nullptr) sm.qseg[s][r] = p.q_seg[(long long)b * p.Sq + q0 + r];
      }
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&sm.full[s], 4 * kStepBoxBytes);
        tma_rows(sm.q[s][0], sm.q[s][1], &maps.q, &sm.full[s], q0, h, b);
        tma_rows(sm.dout[s][0], sm.dout[s][1], &maps.dout, &sm.full[s], q0, h, b);
      } else {
        sm90::mbar_arrive(&sm.full[s]);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    sm90::regs_alloc<240>();
    if (wg >= n_consumers) return;  // all 64 keys past Sk
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int kw0 = k0 + 64 * wg;                  // the warpgroup's first key
    const int key0 = kw0 + 16 * (tid >> 5) + g;   // the two keys this thread holds
    const int key1 = key0 + 8;
    int kvseg0 = 0, kvseg1 = 0;
    if (p.kv_seg != nullptr) {
      kvseg0 = p.kv_seg[(long long)b * p.Sk + key0];
      kvseg1 = p.kv_seg[(long long)b * p.Sk + key1];
    }
    // accumulator fragments: element 4j + e holds key (e < 2 ? key0 : key1),
    // column 8j + 2 * t4 + (e & 1) (a query of the tile, or a head_dim index)
    float dk[64], dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_rows = sm90::smem_u32(sm.k[0]) + wg * 64 * 128;
    const uint32_t v_rows = sm90::smem_u32(sm.v[0]) + wg * 64 * 128;
    sm90::mbar_wait(&sm.tile_full, 0);

    for (int it = 0; it < n_steps; ++it) {
      const int s = it % kWgStages;
      const int q0 = (qt0 + it) * kWgStep;
      sm90::mbar_wait(&sm.full[s], (it / kWgStages) & 1);

      float st[32], dpt[32];
      const uint32_t q_base = sm90::smem_u32(sm.q[s][0]);
      const uint32_t do_base = sm90::smem_u32(sm.dout[s][0]);
      sm90::wgmma_fence();
      k_major_products(st, k_rows, q_base);
      k_major_products(dpt, v_rows, do_base);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      uint32_t pa[4][4], sa[4][4];  // P^T and dS^T as A operands, 16 queries per slice
      const DkvRows rows{key0, key1, kvseg0, kvseg1, t4, q0};
      if ((p.causal && q0 < kw0 + 63) || p.q_seg != nullptr) {
        dkv_scores<true>(st, dpt, sm.lse[s], sm.di[s], sm.qseg[s], p, rows, pa, sa);
      } else {
        dkv_scores<false>(st, dpt, sm.lse[s], sm.di[s], sm.qseg[s], p, rows, pa, sa);
      }

      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::wgmma_fence();
      rs_products(dv, pa, do_base);
      rs_products(dk, sa, q_base);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);
    }

    store_rows(static_cast<bf16*>(p.dv) + b * p.dv_sb + h * p.dv_sh, p.dv_ss, key0, key1, t4, dv);
    sm90::fence_regs(dk);
    store_rows(static_cast<bf16*>(p.dk) + b * p.dk_sb + h * p.dk_sh, p.dk_ss, key0, key1, t4, dk);
  }
}

// Pass 3, dQ. One CTA per (128-query tile, head, batch), heaviest first;
// consumer warpgroup w owns queries q0 + 64w .. +63 and their dQ while the
// producer streams 64-key tiles of K and V (with the key segment ids) up to
// the causal diagonal. Per tile: S = Q K^T and dP = dO V^T (wgmma, K-major
// operands), dS into A-register fragments (rounded to bf16), then dQ += dS K
// (wgmma, K as MN-major B).
__global__ void __launch_bounds__(kWgThreads, 1)
    dq_wgmma_kernel(const BwdParams p, const __grid_constant__ BwdMaps maps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem& sm = aligned_smem<DqSmem>(smem_raw);
  const int n_qtiles = (p.Sq + kWgTile - 1) / kWgTile;
  const int q0 = (n_qtiles - 1 - (int)blockIdx.x) * kWgTile;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_consumers = q0 + 64 < p.Sq ? 2 : 1;  // S % 128 == 64: the last tile's half
  const int last_row = min(q0 + kWgTile, p.Sq) - 1;
  const int n_steps = p.causal ? min(p.Sk / kWgStep, last_row / kWgStep + 1) : p.Sk / kWgStep;
  const int wg = threadIdx.x / 128;
  init_ring(&sm.tile_full, sm.full, sm.empty, n_consumers);

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    sm90::regs_dealloc<24>();
    if (threadIdx.x >= 2 * 128 + 32) return;  // one warp issues everything
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&sm.tile_full, 4 * n_consumers * kStepBoxBytes);
      tma_tile(sm.q[0], sm.q[1], &maps.q, &sm.tile_full, q0, h, b, n_consumers);
      tma_tile(sm.dout[0], sm.dout[1], &maps.dout, &sm.tile_full, q0, h, b, n_consumers);
    }
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % kWgStages;
      const int k0 = it * kWgStep;
      sm90::mbar_wait(&sm.empty[s], ((it / kWgStages) & 1) ^ 1);
      if (p.kv_seg != nullptr) {
#pragma unroll
        for (int i = 0; i < kWgStep / 32; ++i) {
          sm.kvseg[s][lane + 32 * i] = p.kv_seg[(long long)b * p.Sk + k0 + lane + 32 * i];
        }
      }
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&sm.full[s], 4 * kStepBoxBytes);
        tma_rows(sm.k[s][0], sm.k[s][1], &maps.k, &sm.full[s], k0, h, b);
        tma_rows(sm.v[s][0], sm.v[s][1], &maps.v, &sm.full[s], k0, h, b);
      } else {
        sm90::mbar_arrive(&sm.full[s]);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    sm90::regs_alloc<240>();
    if (wg >= n_consumers) return;  // all 64 rows past Sq
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const int r_lo = q0 + 64 * wg;                 // the warpgroup's first query
    const int row0 = r_lo + 16 * (tid >> 5) + g;  // the two queries this thread holds
    const int row1 = row0 + 8;
    const long long stat = ((long long)b * p.H + h) * p.Sq;
    DqRows rows;
    rows.row0 = row0;
    rows.row1 = row1;
    rows.lse0 = p.lse[stat + row0];
    rows.lse1 = p.lse[stat + row1];
    rows.di0 = p.di[stat + row0];
    rows.di1 = p.di[stat + row1];
    rows.qseg0 = p.q_seg != nullptr ? p.q_seg[(long long)b * p.Sq + row0] : 0;
    rows.qseg1 = p.q_seg != nullptr ? p.q_seg[(long long)b * p.Sq + row1] : 0;
    rows.t4 = t4;
    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    const uint32_t q_rows = sm90::smem_u32(sm.q[0]) + wg * 64 * 128;
    const uint32_t do_rows = sm90::smem_u32(sm.dout[0]) + wg * 64 * 128;
    const bool pingpong = n_consumers == 2;
    if (pingpong && wg == 1) sm90::named_arrive(1, 256);
    sm90::mbar_wait(&sm.tile_full, 0);

    // dQ += dS_{it-1} K_{it-1} is still in flight while S_it and dP_it are
    // issued; the one wait per tile covers both (groups complete in order)
    uint32_t sa[4][4];  // dS as the A operand, 16 keys per slice
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % kWgStages;
      const int k0 = it * kWgStep;
      sm90::mbar_wait(&sm.full[s], (it / kWgStages) & 1);

      float sc[32], dp[32];
      const uint32_t k_base = sm90::smem_u32(sm.k[s][0]);
      if (pingpong) sm90::named_sync(1 + wg, 256);
      sm90::wgmma_fence();
      k_major_products(sc, q_rows, k_base);
      k_major_products(dp, do_rows, sm90::smem_u32(sm.v[s][0]));
      sm90::wgmma_commit();
      if (pingpong) sm90::named_arrive(2 - wg, 256);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      sm90::fence_regs(dq);
      sm90::fence_regs(sa);
      if (it > 0) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&sm.empty[(it - 1) % kWgStages]);
      }

      if ((p.causal && k0 + kWgStep - 1 > r_lo) || p.kv_seg != nullptr) {
        dq_scores<true>(sc, dp, sm.kvseg[s], p, k0, rows, sa);
      } else {
        dq_scores<false>(sc, dp, sm.kvseg[s], p, k0, rows, sa);
      }

      if (pingpong) sm90::named_sync(1 + wg, 256);
      sm90::fence_regs(dq);
      sm90::wgmma_fence();
      rs_products(dq, sa, k_base);
      sm90::wgmma_commit();
      if (pingpong && !(wg == 1 && it == n_steps - 1)) sm90::named_arrive(2 - wg, 256);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    sm90::fence_regs(sa);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.empty[(n_steps - 1) % kWgStages]);

    store_rows(static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh, p.dq_ss, row0, row1, t4, dq);
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

template <typename Smem, typename K>
cudaError_t launch_pass(K kernel, int tiles, const BwdParams& p, const BwdMaps& maps,
                        bool* smem_attr_set, cudaStream_t stream) {
  const size_t smem = sizeof(Smem) + 1024;
  if (!*smem_attr_set) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    *smem_attr_set = true;
  }
  kernel<<<dim3(tiles, p.H, p.B), kWgThreads, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

cudaError_t launch_wgmma(const BwdParams& p, cudaStream_t stream) {
  BwdMaps maps;  // both passes read the same four tensors through 64-row boxes
  cudaError_t err;
  using sm90::encode_bsnh;
  if ((err = encode_bsnh(&maps.q, p.q, p.B, p.Sq, p.H, p.q_sb, p.q_ss, p.q_sh, kWgStep)) ||
      (err = encode_bsnh(&maps.k, p.k, p.B, p.Sk, p.H, p.k_sb, p.k_ss, p.k_sh, kWgStep)) ||
      (err = encode_bsnh(&maps.v, p.v, p.B, p.Sk, p.H, p.v_sb, p.v_ss, p.v_sh, kWgStep)) ||
      (err = encode_bsnh(&maps.dout, p.dout, p.B, p.Sq, p.H, p.do_sb, p.do_ss, p.do_sh,
                         kWgStep))) {
    return err;
  }
  if ((err = launch_di<bf16, 128>(p, stream)) != cudaSuccess) return err;
  static bool dkv_attr = false, dq_attr = false;
  err = launch_pass<DkvSmem>(dkv_wgmma_kernel, (p.Sk + kWgTile - 1) / kWgTile, p, maps, &dkv_attr,
                             stream);
  if (err != cudaSuccess) return err;
  return launch_pass<DqSmem>(dq_wgmma_kernel, (p.Sq + kWgTile - 1) / kWgTile, p, maps, &dq_attr,
                             stream);
}

bool rows_aligned(const void* ptr, long long sb, long long ss, long long sh) {
  // base and every row start 16-byte aligned: TMA's rule for global
  // addresses and strides (and the 4-byte stores of the outputs)
  return (reinterpret_cast<uintptr_t>(ptr) % 16 == 0) && sb % 8 == 0 && ss % 8 == 0 &&
         sh % 8 == 0;
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t value on a CUDA failure, or -1 for an
// argument the chosen route does not take (the Python wrapper picks the route
// and checks the rest first). strides: 24 element strides, (batch, seq, head)
// for q, k, v, out, dout, dq, dk, dv in turn. di: (B, H, Sq) fp32 scratch.
// dtype: 0 = float32, 1 = bfloat16. route: 0 = cuda_core, 2 = wgmma (bf16,
// head_dim 128, TMA-eligible rows).
int galv_flash_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, void* dq, void* dk, void* dv,
                        float* di, const int* q_seg, const int* kv_seg,
                        const long long* strides, int B, int H, int Sq, int Sk, int D,
                        int dtype, float sm_scale, int causal, int route, int device,
                        void* stream) {
  if (Sq % 64 != 0 || Sk % 64 != 0 || B < 1 || H < 1 || Sq < 1 || Sk < 1) return -1;
  if (D != 128 && D != 256) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  bool aligned = true;
  for (int i = 0; i < 8; ++i) {
    aligned = aligned && rows_aligned(ptrs[i], strides[3 * i], strides[3 * i + 1],
                                      strides[3 * i + 2]);
  }
  if (route == 2 && !(dtype == 1 && D == 128 && aligned)) return -1;
  if (route != 0 && route != 2) return -1;
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
  if (route == 2) {
    err = launch_wgmma(p, s);
  } else if (dtype == 1) {
    err = D == 128 ? launch_cuda_core<bf16, 128>(p, s) : launch_cuda_core<bf16, 256>(p, s);
  } else {
    err = D == 128 ? launch_cuda_core<float, 128>(p, s) : launch_cuda_core<float, 256>(p, s);
  }
  return (int)err;
}

const char* galv_cuda_error_string(int code) {
  if (code == -1) return "argument not supported by the flash-attention backward kernel on this route";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
