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
// Two device kernels behind one entry point, chosen from the inputs:
//
// * bf16 with 16-byte-aligned rows (the serve path): tensor cores through
//   `mma.sync.m16n8k16` (bf16 in, fp32 accumulate), FlashAttention-2 style.
//   One CTA of 4 warps per (64-row query tile, head, batch); each warp owns
//   16 query rows. Q, K and V tiles (64 x head_dim bf16, rows padded by 16
//   bytes so fragment loads are conflict-free) are staged in shared memory;
//   the logits tile, the running max/sum and the output accumulator stay in
//   registers, and the probabilities go straight from the logits' register
//   layout into the A operand of the P.V product, rounded to bf16 as the
//   Pallas kernel rounds p to v's dtype. V's B operand comes from
//   `ldmatrix.trans`. Loads are synchronous (no cp.async/TMA pipeline) —
//   the next step toward the bound is wgmma + TMA with a producer warp.
// * everything else (fp32 inputs, unaligned bf16 rows): fp32 FMAs on the
//   CUDA cores. One CTA of 256 threads per (64-row query tile, head, batch)
//   stages Q, K and V tiles as fp32 in shared memory; each thread owns 4
//   query rows x 4 key columns of the logits and 4 rows x head_dim/16
//   output columns; row max/sum are reduced with warp shuffles and the
//   probabilities pass through shared memory into P.V.
//
// Both loop over 64-key tiles and stop at the last tile the causal mask
// leaves; query tiles are issued heaviest-first so the causal triangle
// balances across SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

bool rows_16b_aligned(const void* ptr, long long sb, long long ss, long long sh) {
  // 16-byte vector loads of bf16 rows: base and every row start aligned
  return (reinterpret_cast<uintptr_t>(ptr) % 16 == 0) && sb % 8 == 0 && ss % 8 == 0 &&
         sh % 8 == 0;
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
// argument the kernel does not take (the Python wrapper checks these first).
// strides: 12 element strides, (batch, seq, head) for q, k, v, out in turn.
// dtype: 0 = float32, 1 = bfloat16.
int galv_flash_attn_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                        const int* q_seg, const int* kv_seg, const long long* strides,
                        int B, int H, int Sq, int Sk, int D, int dtype, float sm_scale,
                        int causal, int device, void* stream) {
  if (Sq % kBlockQ != 0 || Sk % kBlockK != 0 || B < 1 || H < 1 || Sq < 1 || Sk < 1) return -1;
  if (D != 128 && D != 256) return -1;
  if (dtype != 0 && dtype != 1) return -1;
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
  const bool aligned = rows_16b_aligned(q, p.q_sb, p.q_ss, p.q_sh) &&
                       rows_16b_aligned(k, p.k_sb, p.k_ss, p.k_sh) &&
                       rows_16b_aligned(v, p.v_sb, p.v_ss, p.v_sh) &&
                       rows_16b_aligned(o, p.o_sb, p.o_ss, p.o_sh);
  if (dtype == 1 && aligned) {
    err = D == 128 ? launch_mma<128>(p, s) : launch_mma<256>(p, s);
  } else if (dtype == 1) {
    err = D == 128 ? launch<__nv_bfloat16, 128>(p, s) : launch<__nv_bfloat16, 256>(p, s);
  } else {
    err = D == 128 ? launch<float, 128>(p, s) : launch<float, 256>(p, s);
  }
  return (int)err;
}

const char* galv_cuda_error_string(int code) {
  if (code == -1) return "argument not supported by the flash-attention kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
