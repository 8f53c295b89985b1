// The silent-corruption sentinel's tree fold for sm_90a: one launch folds
// every leaf of a parameter tree into (fold, sumsq).
//
// Replaces galvatron_tpu/runtime/sdc.py::tree_fold_metrics, a jnp loop the
// JAX package runs inside every jitted step under --sdc_check:
//   fold  = sum over every leaf of its elements' uint32 words, mod 2^32
//           (1- and 2-byte elements zero-extended to one word each, 8-byte
//           elements split into two words, bool as uint8);
//   sumsq = sum over the float leaves of x^2 in fp32 (a magnitude trend for
//           telemetry; not order-exact, never compared).
// Wraparound addition is commutative and associative, so the fold is
// bitwise the same for any order, grid or sharding: the Python plain
// version (ops/tree_fold.py) must match it bit for bit.
//
// Design. The host passes a table of leaves (device pointer, element count,
// first tile, element width 1/2/4/8, float kind) and the total tile count; a
// tile is kTile consecutive elements of one leaf, so a large leaf spreads
// over many blocks and a small one costs one tile. A grid-stride loop hands
// tiles to blocks; every thread finds its tile's leaf by binary search in
// the table (the table stays in L1), reads kPerThread elements of the tile
// coalesced (a warp reads 32 consecutive elements per load, kPerThread
// independent loads in flight per thread) and accumulates a uint32 fold and
// an fp32 sum of squares in registers. A warp-shuffle reduction and one
// shared-memory pass per block end in one atomicAdd on unsigned int (which
// wraps mod 2^32, exactly the fold's arithmetic) and one on float.
//
// Bound: the kernel reads every byte of the tree once and writes 8 bytes,
// so its floor is bytes read / 3.35 TB/s (H100 SXM HBM3); the adds are a
// few integer operations per 4-byte word, far under the card's rate.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;
constexpr long long kTile = (long long)kThreads * kPerThread;
constexpr int kFields = 6;  // ptr, n, first tile, width, kind, unused

// float kinds (the table's 5th field)
constexpr int kNotFloat = 0, kF32 = 1, kBF16 = 2, kF16 = 3, kF64 = 4;

template <int kWidth>
__device__ __forceinline__ void fold_tile(const char* base, long long n, long long first,
                                          int kind, unsigned int& fold, float& sq) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = first + (long long)k * kThreads + threadIdx.x;
    if (i >= n) break;
    if (kWidth == 1) {
      fold += (unsigned int)__ldg(reinterpret_cast<const unsigned char*>(base) + i);
    } else if (kWidth == 2) {
      const unsigned int w = __ldg(reinterpret_cast<const unsigned short*>(base) + i);
      fold += w;
      if (kind == kBF16) {
        const float f = __uint_as_float(w << 16);
        sq = fmaf(f, f, sq);
      } else if (kind == kF16) {
        const float f = __half2float(__ushort_as_half((unsigned short)w));
        sq = fmaf(f, f, sq);
      }
    } else if (kWidth == 4) {
      const unsigned int w = __ldg(reinterpret_cast<const unsigned int*>(base) + i);
      fold += w;
      if (kind == kF32) {
        const float f = __uint_as_float(w);
        sq = fmaf(f, f, sq);
      }
    } else {
      const unsigned long long w = __ldg(reinterpret_cast<const unsigned long long*>(base) + i);
      fold += (unsigned int)(w & 0xffffffffull) + (unsigned int)(w >> 32);
      if (kind == kF64) {
        const float f = (float)__longlong_as_double((long long)w);
        sq = fmaf(f, f, sq);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
tree_fold_kernel(const long long* __restrict__ table, int n_leaves, long long n_tiles,
                 unsigned int* __restrict__ fold_out, float* __restrict__ sumsq_out) {
  unsigned int fold = 0u;
  float sq = 0.f;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int lo = 0, hi = n_leaves - 1;  // the last leaf whose first tile is <= t
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(table + (long long)mid * kFields + 2) <= t) lo = mid; else hi = mid - 1;
    }
    const long long* e = table + (long long)lo * kFields;
    const char* base = reinterpret_cast<const char*>(static_cast<uintptr_t>(__ldg(e)));
    const long long n = __ldg(e + 1);
    const long long first = (t - __ldg(e + 2)) * kTile;
    const int width = (int)__ldg(e + 3);
    const int kind = (int)__ldg(e + 4);
    switch (width) {
      case 1: fold_tile<1>(base, n, first, kind, fold, sq); break;
      case 2: fold_tile<2>(base, n, first, kind, fold, sq); break;
      case 4: fold_tile<4>(base, n, first, kind, fold, sq); break;
      default: fold_tile<8>(base, n, first, kind, fold, sq); break;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    fold += __shfl_xor_sync(0xffffffffu, fold, off);
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  }
  __shared__ unsigned int s_fold[kThreads / 32];
  __shared__ float s_sq[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_fold[warp] = fold;
    s_sq[warp] = sq;
  }
  __syncthreads();
  if (warp == 0) {
    fold = lane < kThreads / 32 ? s_fold[lane] : 0u;
    sq = lane < kThreads / 32 ? s_sq[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      fold += __shfl_xor_sync(0xffffffffu, fold, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (lane == 0) {
      atomicAdd(fold_out, fold);  // unsigned int atomics wrap mod 2^32
      atomicAdd(sumsq_out, sq);
    }
  }
}

}  // namespace

extern "C" {

// The elements per tile (the host lays the table's first-tile column out
// with it).
long long galv_tree_fold_tile() { return kTile; }

// Returns 0 on success, a cudaError_t value on a CUDA failure, or -1 for a
// bad argument. table: n_leaves rows of 6 int64 (device pointer, element
// count > 0, first tile, width 1/2/4/8, float kind 0-4, unused), rows in
// tile order, on the device; out: 8 bytes on the device, zeroed here on
// `stream`, then the uint32 fold at byte 0 and the fp32 sum of squares at
// byte 4.
int galv_tree_fold(const long long* table, int n_leaves, long long n_tiles, void* out,
                   int max_blocks, int device, void* stream) {
  if (n_leaves < 1 || n_tiles < 1 || out == nullptr || table == nullptr || max_blocks < 1)
    return -1;
  // launch on `device`, then give the calling thread its own current device
  // back (the caller's, and with it torch's, stays as it was)
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return (int)err;
  if (caller != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, 8, s);
  if (err == cudaSuccess) {
    const long long blocks = n_tiles < (long long)max_blocks ? n_tiles : (long long)max_blocks;
    unsigned int* fold = reinterpret_cast<unsigned int*>(out);
    float* sumsq = reinterpret_cast<float*>(reinterpret_cast<char*>(out) + 4);
    tree_fold_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(table, n_leaves, n_tiles, fold, sumsq);
    err = cudaGetLastError();
  }
  if (caller != device) {
    const cudaError_t back = cudaSetDevice(caller);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

const char* galv_cuda_error_string(int code) {
  if (code == -1) return "argument not supported by the tree-fold kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
