// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `galvatron_tpu/ops/attention.py::_pallas_flash`
// (forward `pallas_call` of jax.experimental.pallas.ops.tpu.flash_attention):
//   out = softmax(q k^T * sm_scale + mask) v, per (batch, head),
// with an online softmax and fp32 accumulation. Masks: causal (key position
// <= query position) and optional int32 segment ids (a query sees only keys
// of its own segment). A masked logit gets DEFAULT_MASK_VALUE (-0.7 * f32
// max) ADDED, exactly as the Pallas kernel does, never -inf, so a key tile
// that is fully masked for a row cannot produce NaN. Also writes the fp32
// logsumexp (B, H, Sq) that the backward will read.
//
// Layout: q, k, v and out are BSNH, read and written in place through their
// (batch, seq, head) element strides; the head dim must be contiguous. No
// transposes. Inputs are bf16 or fp32; products accumulate and the softmax
// runs in fp32; out is the input dtype.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): prefill at
// B=1, S=2048, nh=32, hd=128, causal does ~34 GFLOP (~35 us) on ~67 MB of
// q/k/v/o (~20 us), so the kernel is compute-bound.
//
// Three device kernels behind one entry point; the Python wrapper picks the
// route (`flash_route`) and this file refuses (-1) a route that does not
// take the arguments:
//
// * route 2, "wgmma" (bf16, head_dim 128, every base 16-byte aligned and
//   every (batch, seq, head) stride a multiple of 8 elements: TMA's rule;
//   the serve and train paths): Hopper's own machinery, FlashAttention-3's
//   shape kept simple. One CTA of three warpgroups per (128-query tile,
//   head, batch). The producer warp (warpgroup 2, its registers cut to 24
//   by `setmaxnreg`) loads Q once and streams 128-key tiles of K and V, plus
//   the tile's key segment ids, through a 3-stage ring of shared memory with
//   TMA (4-D tensor maps over the strided BSNH views, so a fused qkv
//   projection is read in place; 128-byte swizzle, so a 128-wide head is two
//   64-column boxes) and full/empty mbarriers. Consumer warpgroups 0 and 1
//   (240 registers each) own 64 query rows: S = Q K^T by `wgmma` (both
//   operands from shared memory, K-major), the online softmax on the
//   accumulator fragment in registers (in base 2: the logits are scaled by
//   sm_scale * log2(e)), P rounded to bf16 straight into wgmma's A-register
//   fragment, and O += P V by `wgmma` with V as an MN-major B operand.
//   Each warpgroup issues S_j together with P_{j-1} V_{j-1} and runs the
//   softmax of S_j while P.V is in flight, and the two warpgroups take turns
//   issuing (ping-pong on named barriers), so one's softmax overlaps the
//   other's products: the softmax (an EX2, an FFMA, a max and an add per
//   logit) costs about as much issue time as the products. 128-key tiles
//   halve the barrier round trips of 64-key ones and keep S (64 fp32), P
//   (32 registers) and O (64 fp32) within the consumers' budget. Only tiles
//   that cross the causal diagonal, run past Sk, or hold a segment id other
//   than the rows' (the producer flags tiles of one id with a warp vote)
//   take the mask pass. Keys at or past Sk (TMA zero-fills them when
//   S % 128 == 64) are excluded outright (-inf, p = 0); a warpgroup whose 64
//   rows lie past Sq does no product and stores nothing.
// * route 1, "mma" (bf16, head_dim 256, the same alignment): tensor cores
//   through `mma.sync.m16n8k16` (bf16 in, fp32 accumulate), FlashAttention-2
//   style. One CTA of 4 warps per (64-row query tile, head, batch); each warp
//   owns 16 query rows. Q, K and V tiles (rows padded by 16 bytes so
//   fragment loads are conflict-free) are staged in shared memory with
//   synchronous loads; the logits tile, the running max/sum and the output
//   accumulator stay in registers, and the probabilities go straight from
//   the logits' register layout into the A operand of the P.V product,
//   rounded to bf16 as the Pallas kernel rounds p to v's dtype. V's B
//   operand comes from `ldmatrix.trans`.
// * route 0, "cuda_core" (everything else: fp32 inputs, unaligned bf16
//   rows): fp32 FMAs on the CUDA cores. One CTA of 256 threads per (64-row
//   query tile, head, batch) stages Q, K and V tiles as fp32 in shared
//   memory; each thread owns 4 query rows x 4 key columns of the logits and
//   4 rows x head_dim/16 output columns; row max/sum are reduced with warp
//   shuffles and the probabilities pass through shared memory into P.V.
//
// All stop at the last key tile the causal mask leaves; query tiles are
// issued heaviest-first so the causal triangle balances across SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kRows = 4;           // query rows per thread
constexpr int kCols = 4;           // key columns per thread
constexpr int kPStride = kBlockK + 4;  // rows of the two half-warps land 16 banks apart
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* q_seg;   // (B, Sq) contiguous, or null
  const int* kv_seg;  // (B, Sk) contiguous, or null
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, H, Sq, Sk;
  float sm_scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q, K, V tiles (rows padded by one float against bank conflicts), the
  // probability tile and the key segment ids of the current tile.
  return sizeof(float) * (size_t)(3 * kBlockQ * (D + 1) + kBlockQ * kPStride) +
         sizeof(int) * kBlockK;
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int rows) {
  // rows x D elements, row r at src + r * row_stride, into dst[r * (D + 1) + d].
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * (D + 1) + d] = to_f32(src[(long long)r * row_stride + d]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int kOutCols = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBlockQ * (D + 1);
  float* v_s = k_s + kBlockK * (D + 1);
  float* p_s = v_s + kBlockK * (D + 1);
  int* kvseg_s = reinterpret_cast<int*>(p_s + kBlockQ * kPStride);

  const int n_qtiles = p.Sq / kBlockQ;
  const int qt = n_qtiles - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBlockQ;
  const int tx = threadIdx.x & 15;  // key / output column group
  const int ty = threadIdx.x >> 4;  // query row group

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + (long long)q0 * p.q_ss + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  load_tile<T, D>(q_s, qg, p.q_ss, kBlockQ);

  int qseg[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    qseg[i] = p.q_seg ? p.q_seg[(long long)b * p.Sq + q0 + ty * kRows + i] : 0;
  }

  float m_run[kRows], l_run[kRows];
  float acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.f;
  }

  const int n_ktiles_all = p.Sk / kBlockK;
  const int n_ktiles =
      p.causal ? min(n_ktiles_all, (q0 + kBlockQ - 1) / kBlockK + 1) : n_ktiles_all;

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, D>(k_s, kg + (long long)k0 * p.k_ss, p.k_ss, kBlockK);
    load_tile<T, D>(v_s, vg + (long long)k0 * p.v_ss, p.v_ss, kBlockK);
    if (p.kv_seg != nullptr && threadIdx.x < kBlockK) {
      kvseg_s[threadIdx.x] = p.kv_seg[(long long)b * p.Sk + k0 + threadIdx.x];
    }
    __syncthreads();

    // logits tile: rows ty*4+i, columns tx+16*j
    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kRows], c[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = q_s[(ty * kRows + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) c[j] = k_s[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        bool keep = true;
        if (p.kv_seg != nullptr) keep = (qseg[i] == kvseg_s[tx + 16 * j]);
        if (p.causal) keep = keep && (col <= row);
        s[i][j] = s[i][j] * p.sm_scale + (keep ? 0.f : kMaskValue);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);  // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pij = expf(s[i][j] - m_new);
        sum += pij;
        p_s[(ty * kRows + i) * kPStride + tx + 16 * j] = pij;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P . V
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pr[i] = p_s[(ty * kRows + i) * kPStride + kk];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) {
        const float vv = v_s[kk * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
      }
    }
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + (long long)q0 * p.o_ss + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    const float inv = l_run[i] == 0.f ? 1.f : 1.f / l_run[i];
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      og[(long long)r * p.o_ss + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    }
    if (tx == 0) {
      p.lse[((long long)b * p.H + h) * p.Sq + q0 + r] = m_run[i] + logf(l_run[i]);
    }
  }
}

// ---------------------------------------------------------- tensor-core path
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows = kBlockQ

template <int D>
__host__ __device__ constexpr int mma_stride() { return D + 8; }  // bf16 per row, +16 B

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(3 * kBlockQ * mma_stride<D>()) +
         sizeof(int) * kBlockK;
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const __nv_bfloat16* ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long row_stride) {
  // kBlockQ rows x D, 16 bytes per thread per step (rows are 16-byte aligned)
  constexpr int kVecs = D / 8;
  for (int idx = threadIdx.x; idx < kBlockQ * kVecs; idx += kMmaThreads) {
    const int r = idx / kVecs;
    const int c = (idx - r * kVecs) * 8;
    *reinterpret_cast<uint4*>(dst + r * mma_stride<D>() + c) =
        *reinterpret_cast<const uint4*>(src + (long long)r * row_stride + c);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(const Params p) {
  constexpr int S = mma_stride<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBlockQ * S;
  __nv_bfloat16* v_s = k_s + kBlockK * S;
  int* kvseg_s = reinterpret_cast<int*>(v_s + kBlockK * S);

  const int n_qtiles = p.Sq / kBlockQ;
  const int qt = n_qtiles - 1 - (int)blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBlockQ;
  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16;  // the warp's first row in the tile
  const int g = lane >> 2;                   // fragment row (and +8)
  const int t4 = lane & 3;                   // fragment column pair

  typedef __nv_bfloat16 bf16;
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + (long long)q0 * p.q_ss + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  load_tile_bf16<D>(q_s, qg, p.q_ss);

  const int row0 = q0 + wrow + g;  // the two query rows this thread holds
  const int row1 = row0 + 8;
  int qseg0 = 0, qseg1 = 0;
  if (p.q_seg != nullptr) {
    qseg0 = p.q_seg[(long long)b * p.Sq + row0];
    qseg1 = p.q_seg[(long long)b * p.Sq + row1];
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const int n_ktiles_all = p.Sk / kBlockK;
  const int n_ktiles =
      p.causal ? min(n_ktiles_all, (q0 + kBlockQ - 1) / kBlockK + 1) : n_ktiles_all;

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile_bf16<D>(k_s, kg + (long long)k0 * p.k_ss, p.k_ss);
    load_tile_bf16<D>(v_s, vg + (long long)k0 * p.v_ss, p.v_ss);
    if (p.kv_seg != nullptr && threadIdx.x < kBlockK) {
      kvseg_s[threadIdx.x] = p.kv_seg[(long long)b * p.Sk + k0 + threadIdx.x];
    }
    __syncthreads();

    // logits: 16 rows x 64 keys per warp, as 8 m16n8 accumulator tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* qa = q_s + (wrow + g) * S + kk * 16 + t4 * 2;
      const uint32_t a[4] = {lds32(qa), lds32(qa + 8 * S), lds32(qa + 8), lds32(qa + 8 * S + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* kb = k_s + (j * 8 + g) * S + kk * 16 + t4 * 2;
        const uint32_t bfrag[2] = {lds32(kb), lds32(kb + 8)};
        mma_16816(s[j], a, bfrag);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
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
        s[j][e] = s[j][e] * p.sm_scale + (keep0 ? 0.f : kMaskValue);
        s[j][2 + e] = s[j][2 + e] * p.sm_scale + (keep1 ? 0.f : kMaskValue);
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    // a row's 64 columns live in the 4 lanes of one quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);  // 0 on the first tile
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // acc += P . V: the logits' accumulator layout is the A operand layout
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = v_s + (kk * 16 + (lane & 15)) * S;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t bfrag[2];
        ldmatrix_x2_trans(bfrag, vrow + n * 8);
        mma_16816(acc[n], a, bfrag);
      }
    }
  }

  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + t4 * 2;
    *reinterpret_cast<__nv_bfloat162*>(og + (long long)row0 * p.o_ss + d) =
        __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    *reinterpret_cast<__nv_bfloat162*>(og + (long long)row1 * p.o_ss + d) =
        __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (t4 == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
    lse[row0] = m0 + logf(l0);
    lse[row1] = m1 + logf(l1);
  }
}

template <int D>
cudaError_t launch_mma(const Params& p, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  static bool smem_attr_set = false;  // one per instantiation
  if (!smem_attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_attr_set = true;
  }
  dim3 grid(p.Sq / kBlockQ, p.H, p.B);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- wgmma path
constexpr int kWgRows = 128;    // query rows per CTA: two consumer warpgroups of 64
constexpr int kWgKeys = 128;    // keys per pipeline stage
constexpr int kWgStages = 3;
constexpr int kWgThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kBoxCols = 64;     // head_dim columns per TMA box: 128 bytes, the swizzle width
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdMaps {
  CUtensorMap q, k, v;  // boxes of 64 columns x 128 rows
};

struct FwdSmem {
  __nv_bfloat16 q[2][kWgRows * kBoxCols];  // 16 KB per box, 1024-byte aligned
  __nv_bfloat16 k[kWgStages][2][kWgKeys * kBoxCols];
  __nv_bfloat16 v[kWgStages][2][kWgKeys * kBoxCols];
  int kvseg[kWgStages][kWgKeys];
  int kvseg_same[kWgStages];  // 1 when every key of the tile has the segment id kvseg[s][0]
  uint64_t q_full;
  uint64_t full[kWgStages];
  uint64_t empty[kWgStages];
};

constexpr uint32_t kQBytes = 2 * kWgRows * kBoxCols * 2;
constexpr uint32_t kKVBytes = 2 * 2 * kWgKeys * kBoxCols * 2;
constexpr uint32_t kKeyBoxBytes = kWgKeys * kBoxCols * 2;

__device__ __forceinline__ FwdSmem& fwd_smem(unsigned char* raw) {
  // the 128B swizzle wants 1024-byte aligned boxes; one spare KB is allocated
  return *reinterpret_cast<FwdSmem*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// S = Q K^T for one warpgroup: 64 rows x 128 keys over head_dim 128 (two
// boxes of 64 columns, four 16-column slices each), both operands K-major.
__device__ __forceinline__ void fwd_qk(float (&sc)[64], uint32_t q_rows, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint32_t q_off = (kk >> 2) * (kQBytes / 2) + (kk & 3) * 32;
    const uint32_t k_off = (kk >> 2) * kKeyBoxBytes + (kk & 3) * 32;
    sm90::wgmma_m64n128k16_ss(sc, sm90::desc_k_major(q_rows + q_off),
                              sm90::desc_k_major(k_base + k_off), kk > 0);
  }
}

// O += P V: P from registers, V (128 keys x head_dim 128) as an MN-major B
__device__ __forceinline__ void fwd_pv(float (&o)[64], const uint32_t (&pa)[8][4],
                                       uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    sm90::wgmma_m64n128k16_rs_mn(o, pa[kk], sm90::desc_mn_major(v_base + kk * 2048, kKeyBoxBytes));
  }
}

struct FwdRows {
  int row0, row1;    // the two query rows a thread holds
  int qseg0, qseg1;  // their segment ids (0 without segment ids)
  int t4;            // column pair within an 8-column group
  int r_lo;          // the warpgroup's first row
  float c;           // sm_scale * log2(e)
};

// The mask of one tile, in place: sc goes from the logits to
// y = s * sm_scale * log2(e), the mask value where masked (s * scale + mask
// rounds to the mask value in fp32) and -inf past Sk (no such key).
__device__ __forceinline__ void fwd_mask(float (&sc)[64], const Params& p, const int* kvseg,
                                         int k0, const FwdRows& r) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cj = 8 * j + 2 * r.t4 + (e & 1);
      const int col = k0 + cj;
      bool keep = !p.causal || col <= (e < 2 ? r.row0 : r.row1);
      if (p.kv_seg != nullptr) keep = keep && (e < 2 ? r.qseg0 : r.qseg1) == kvseg[cj];
      const float y = keep ? sc[4 * j + e] * r.c : kMaskValue;
      sc[4 * j + e] = col < p.Sk ? y : -INFINITY;
    }
  }
}

// One tile of the online softmax, in base 2, in place: sc goes from the
// logits to p = 2^(y - m), y = s * sm_scale * log2(e) (or what fwd_mask made
// of it); the running max m and partial sums l are updated, and
// alpha = 2^(m_old - m_new) is what the output must be rescaled by. Tiles
// that no mask touches skip fwd_mask and fold the scale into one FFMA per
// element (the scale is positive, so the max of s gives the max of y). A
// tile whose keys all share one segment id, which is also both of the
// thread's rows' (the body of a padded prompt), needs no segment test;
// the decision is per thread, the same across each quad that shares rows.
__device__ __forceinline__ void fwd_softmax(float (&sc)[64], const Params& p, const int* kvseg,
                                            int kvseg_same, int k0, const FwdRows& r, float& m0,
                                            float& m1, float& l0, float& l1, float& alpha0,
                                            float& alpha1) {
  const bool seg_masked = p.kv_seg != nullptr &&
                          !(kvseg_same && r.qseg0 == kvseg[0] && r.qseg1 == kvseg[0]);
  const bool masked =
      (p.causal && k0 + kWgKeys - 1 > r.r_lo) || seg_masked || k0 + kWgKeys > p.Sk;
  float c = r.c;
  if (masked) {
    fwd_mask(sc, p, kvseg, k0, r);
    c = 1.f;
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  // a row's columns live in the 4 lanes of one quad
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
  alpha0 = sm90::exp2_approx(m0 - mn0);  // 0 on the first tile
  alpha1 = sm90::exp2_approx(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j] = sm90::exp2_approx(fmaf(sc[4 * j], c, -mn0));
    sc[4 * j + 1] = sm90::exp2_approx(fmaf(sc[4 * j + 1], c, -mn0));
    sc[4 * j + 2] = sm90::exp2_approx(fmaf(sc[4 * j + 2], c, -mn1));
    sc[4 * j + 3] = sm90::exp2_approx(fmaf(sc[4 * j + 3], c, -mn1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = l0 * alpha0 + sum0;
  l1 = l1 * alpha1 + sum1;
}

// p (fp32 accumulator layout) rounded to bf16 into the A fragments of P.V:
// slice kk holds keys 16kk..16kk+15 = column groups 2kk and 2kk + 1
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4], const float (&sc)[64]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pa[j >> 1][(j & 1) * 2] = pack_bf16x2(sc[4 * j], sc[4 * j + 1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const Params p, const __grid_constant__ FwdMaps maps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = fwd_smem(smem_raw);

  const int n_qtiles = (p.Sq + kWgRows - 1) / kWgRows;
  const int q0 = (n_qtiles - 1 - (int)blockIdx.x) * kWgRows;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_consumers = q0 + 64 < p.Sq ? 2 : 1;  // S % 128 == 64: the last tile's half
  const int last_row = min(q0 + kWgRows, p.Sq) - 1;
  const int n_ktiles_all = (p.Sk + kWgKeys - 1) / kWgKeys;
  const int n_ktiles = p.causal ? min(n_ktiles_all, last_row / kWgKeys + 1) : n_ktiles_all;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&sm.q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      sm90::mbar_init(&sm.full[s], 32);                 // every producer lane
      sm90::mbar_init(&sm.empty[s], 4 * n_consumers);  // every consumer warp
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    sm90::regs_dealloc<24>();
    if (threadIdx.x >= 2 * 128 + 32) return;  // one warp issues everything
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&sm.q_full, kQBytes);
      sm90::tma_load_4d(sm.q[0], &maps.q, &sm.q_full, 0, q0, h, b);
      sm90::tma_load_4d(sm.q[1], &maps.q, &sm.q_full, kBoxCols, q0, h, b);
    }
    for (int it = 0; it < n_ktiles; ++it) {
      const int s = it % kWgStages;
      const int k0 = it * kWgKeys;
      sm90::mbar_wait(&sm.empty[s], ((it / kWgStages) & 1) ^ 1);
      if (p.kv_seg != nullptr) {
        const int first = p.kv_seg[(long long)b * p.Sk + k0];  // k0 < Sk: a real key
        bool same = true;
#pragma unroll
        for (int i = 0; i < kWgKeys / 32; ++i) {
          const int key = k0 + lane + 32 * i;
          const int id = key < p.Sk ? p.kv_seg[(long long)b * p.Sk + key] : first;
          sm.kvseg[s][lane + 32 * i] = id;
          same = same && id == first;
        }
        same = __all_sync(0xffffffffu, same);
        if (lane == 0) sm.kvseg_same[s] = same;
      }
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&sm.full[s], kKVBytes);
        sm90::tma_load_4d(sm.k[s][0], &maps.k, &sm.full[s], 0, k0, h, b);
        sm90::tma_load_4d(sm.k[s][1], &maps.k, &sm.full[s], kBoxCols, k0, h, b);
        sm90::tma_load_4d(sm.v[s][0], &maps.v, &sm.full[s], 0, k0, h, b);
        sm90::tma_load_4d(sm.v[s][1], &maps.v, &sm.full[s], kBoxCols, k0, h, b);
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
    const int r_lo = q0 + 64 * wg;                  // the warpgroup's first query row
    const int row0 = r_lo + 16 * (tid >> 5) + g;   // the two rows this thread holds
    const int row1 = row0 + 8;
    int qseg0 = 0, qseg1 = 0;
    if (p.q_seg != nullptr) {
      qseg0 = p.q_seg[(long long)b * p.Sq + row0];
      qseg1 = p.q_seg[(long long)b * p.Sq + row1];
    }

    // accumulator fragment of m64nN: element 4j + e holds row (e < 2 ? row0
    // : row1), column 8j + 2 * t4 + (e & 1)
    float o[64], sc[64];
    uint32_t pa[8][4];  // P as the A operand of P.V, 16 keys per slice
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // base-2 max, partial sums
    const FwdRows rows{row0, row1, qseg0, qseg1, t4, r_lo, p.sm_scale * kLog2e};

    // Ping-pong: the two warpgroups take turns issuing their products
    // (named barrier 1 + w is "warpgroup w may issue"), so one's softmax runs
    // while the other's products keep the tensor cores busy. Warpgroup 1
    // opens by letting warpgroup 0 go first; each issue passes the turn, and
    // warpgroup 1 skips the pass after its last issue, which nobody awaits.
    const bool pingpong = n_consumers == 2;
    if (pingpong && wg == 1) sm90::named_arrive(1, 256);

    const uint32_t q_rows = sm90::smem_u32(sm.q[0]) + wg * 64 * 128;  // this warpgroup's rows
    sm90::mbar_wait(&sm.q_full, 0);

    // tile 0: S_0 alone
    sm90::mbar_wait(&sm.full[0], 0);
    if (pingpong) sm90::named_sync(1 + wg, 256);
    sm90::wgmma_fence();
    fwd_qk(sc, q_rows, sm90::smem_u32(sm.k[0][0]));
    sm90::wgmma_commit();
    if (pingpong) sm90::named_arrive(2 - wg, 256);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    float alpha0, alpha1;
    fwd_softmax(sc, p, sm.kvseg[0], sm.kvseg_same[0], 0, rows, m0, m1, l0, l1, alpha0, alpha1);
    pack_p(pa, sc);

    // tile it: S_it issued with O += P_{it-1} V_{it-1}; the softmax of S_it
    // runs while P.V is in flight, and P_it is packed once P.V has read
    // P_{it-1} from the registers
    for (int it = 1; it < n_ktiles; ++it) {
      const int s = it % kWgStages;
      const int prev = (it - 1) % kWgStages;
      sm90::mbar_wait(&sm.full[s], (it / kWgStages) & 1);
      if (pingpong) sm90::named_sync(1 + wg, 256);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
      fwd_qk(sc, q_rows, sm90::smem_u32(sm.k[s][0]));
      sm90::wgmma_commit();
      fwd_pv(o, pa, sm90::smem_u32(sm.v[prev][0]));
      sm90::wgmma_commit();
      if (pingpong) sm90::named_arrive(2 - wg, 256);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      fwd_softmax(sc, p, sm.kvseg[s], sm.kvseg_same[s], it * kWgKeys, rows, m0, m1, l0, l1, alpha0,
                  alpha1);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.empty[prev]);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }
      pack_p(pa, sc);
    }

    // the last tile's P.V
    const int last = (n_ktiles - 1) % kWgStages;
    if (pingpong) sm90::named_sync(1 + wg, 256);
    sm90::fence_regs(o);
    sm90::wgmma_fence();
    fwd_pv(o, pa, sm90::smem_u32(sm.v[last][0]));
    sm90::wgmma_commit();
    if (pingpong && wg == 0) sm90::named_arrive(2, 256);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.empty[last]);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    typedef __nv_bfloat16 bf16;
    bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
    const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int d = 8 * j + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row0 * p.o_ss + d) =
          __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(og + (long long)row1 * p.o_ss + d) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if (t4 == 0) {
      // natural-log lse; a row every key of which was masked has its max at
      // the mask value itself, as the plain version has
      float* lse = p.lse + ((long long)b * p.H + h) * p.Sq;
      lse[row0] = (m0 == kMaskValue ? m0 : m0 * kLn2) + logf(l0);
      lse[row1] = (m1 == kMaskValue ? m1 : m1 * kLn2) + logf(l1);
    }
  }
}

bool rows_aligned(const void* ptr, long long sb, long long ss, long long sh) {
  // base and every row start 16-byte aligned: the vector loads of the mma
  // route and TMA's rule for global addresses and strides
  return (reinterpret_cast<uintptr_t>(ptr) % 16 == 0) && sb % 8 == 0 && ss % 8 == 0 &&
         sh % 8 == 0;
}

cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  FwdMaps maps;
  cudaError_t err;
  if ((err = sm90::encode_bsnh(&maps.q, p.q, p.B, p.Sq, p.H, p.q_sb, p.q_ss, p.q_sh, kWgRows)) !=
          cudaSuccess ||
      (err = sm90::encode_bsnh(&maps.k, p.k, p.B, p.Sk, p.H, p.k_sb, p.k_ss, p.k_sh, kWgKeys)) !=
          cudaSuccess ||
      (err = sm90::encode_bsnh(&maps.v, p.v, p.B, p.Sk, p.H, p.v_sb, p.v_ss, p.v_sh, kWgKeys)) !=
          cudaSuccess) {
    return err;
  }
  const size_t smem = sizeof(FwdSmem) + 1024;
  static bool smem_attr_set = false;
  if (!smem_attr_set) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    smem_attr_set = true;
  }
  dim3 grid((p.Sq + kWgRows - 1) / kWgRows, p.H, p.B);
  flash_fwd_wgmma_kernel<<<grid, kWgThreads, smem, stream>>>(p, maps);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  static bool smem_attr_set = false;  // one per instantiation
  if (!smem_attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_attr_set = true;
  }
  dim3 grid(p.Sq / kBlockQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 on success, a cudaError_t value on a CUDA failure, or -1 for an
// argument the chosen route does not take (the Python wrapper picks the route
// and checks the rest first). strides: 12 element strides, (batch, seq, head)
// for q, k, v, out in turn. dtype: 0 = float32, 1 = bfloat16. route: 0 =
// cuda_core, 1 = mma (bf16, head_dim 256), 2 = wgmma (bf16, head_dim 128).
int galv_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        const int* q_seg, const int* kv_seg, const long long* strides,
                        int B, int H, int Sq, int Sk, int D, int dtype, float sm_scale,
                        int causal, int route, int device, void* stream) {
  if (Sq % kBlockQ != 0 || Sk % kBlockK != 0 || B < 1 || H < 1 || Sq < 1 || Sk < 1) return -1;
  if (D != 128 && D != 256) return -1;
  if (dtype != 0 && dtype != 1) return -1;
  const bool aligned = rows_aligned(q, strides[0], strides[1], strides[2]) &&
                       rows_aligned(k, strides[3], strides[4], strides[5]) &&
                       rows_aligned(v, strides[6], strides[7], strides[8]) &&
                       rows_aligned(o, strides[9], strides[10], strides[11]);
  if (route == 2 && !(dtype == 1 && D == 128 && aligned)) return -1;
  if (route == 1 && !(dtype == 1 && D == 256 && aligned)) return -1;
  if (route < 0 || route > 2) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.q_seg = q_seg; p.kv_seg = kv_seg;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.B = B; p.H = H; p.Sq = Sq; p.Sk = Sk;
  p.sm_scale = sm_scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    err = launch_wgmma(p, s);
  } else if (route == 1) {
    err = launch_mma<256>(p, s);
  } else if (dtype == 1) {
    err = D == 128 ? launch<__nv_bfloat16, 128>(p, s) : launch<__nv_bfloat16, 256>(p, s);
  } else {
    err = D == 128 ? launch<float, 128>(p, s) : launch<float, 256>(p, s);
  }
  return (int)err;
}

const char* galv_cuda_error_string(int code) {
  if (code == -1) return "argument not supported by the flash-attention kernel on this route";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
