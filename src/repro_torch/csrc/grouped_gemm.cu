// Grouped (expert-aggregated) GEMM for Hopper (sm_90a): every expert's
// product over the tokens routed to it, in one launch over the capacity
// layout of a MoE layer.
//
//   x (E, C, K) @ w (E, K, N), group_len (E,) int32  ->  out (E, C, N)
//
// fp32 or bf16 inputs and output, fp32 accumulation.  Row r of expert e is
// computed only for r < group_len[e] (clamped to [0, C]); rows at or beyond
// it are written as exact zeros, and neither their x rows nor, for an
// expert with no rows, its w are ever read.  Replaces the TPU kernel
// src/repro/kernels/grouped_gemm.py::_gg_kernel (which streams every
// expert's w tiles even where it skips the product).
//
// What bounds it on an H100: bytes, at decode.  A bucket of 8 tokens routes
// at most 32 (token, expert) rows over 60 experts: each live expert's w
// (2048 x 1408 bf16, 5.8 MB) is read for one or two rows, about 2 operations
// per byte read against the card's ~295.  The live experts' w, the live x
// rows and the whole output are the bytes the function must move.
//
// What the design does about it:
//  * One block per (N tile of 128 columns, expert); an expert with
//    group_len == 0 writes its zeros and returns without loading w.
//  * 256 threads: 16 column groups of 8 columns (one 16-byte bf16 load of a
//    w row each) by 16 k-slices; a warp's 32 lanes read two 256-byte runs
//    of two consecutive w rows.  Each thread keeps an 8-row x 8-column fp32
//    accumulator in registers, so a w row is read once per 8 live rows.
//  * x rows of the tile are staged in shared memory as fp32, 1,024 of K at
//    a time; rows past group_len are neither read nor multiplied.
//  * The 16 k-slices are summed in a fixed order (a shuffle between the two
//    slices of a warp, then the 8 warps in turn through shared memory), so
//    a row's result depends on its own x row and w alone: not on the other
//    rows, on group_len or on the bucket.
//  * Plain fp32 FMAs on the CUDA cores: the tensor-core (wgmma, TMA) design
//    is later work; at decode the weight bytes, not the arithmetic, set the
//    time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "lm_common.cuh"

namespace {

using lm::load8;
using lm::store;
using lm::to_f32;

constexpr int kThreads = 256;
constexpr int kBN = 128;                      // output columns per block
constexpr int kCols = 8;                      // columns per thread
constexpr int kGroups = kBN / kCols;          // 16 column groups
constexpr int kSlices = kThreads / kGroups;   // 16 k-slices
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 8;                        // rows per row tile
constexpr int kKC = 1024;                     // K staged per chunk
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps * kBM * kBN == kBM * kKC,
              "the x chunk and the reduction share one buffer");

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ group_len, T* __restrict__ out,
                    int C, int K, int N) {
  // x chunk (kBM rows x kKC) while accumulating; per-warp partial sums
  // (kWarps x kBM x kBN) while reducing
  __shared__ float smem[kBM * kKC];
  const int e = blockIdx.y, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = tid % kGroups, ks = tid / kGroups;
  const int gl = min(max(group_len[e], 0), C);
  const T* xe = x + (size_t)e * C * K;
  const T* we = w + (size_t)e * K * N;
  T* oe = out + (size_t)e * C * N;
  const int col = n0 + cg * kCols;            // N % 8 == 0: whole groups
  const bool col_ok = col < N;

  int r0 = 0;
  for (; r0 < gl; r0 += kBM) {
    const int nrows = min(kBM, gl - r0);
    float acc[kBM][kCols];
#pragma unroll
    for (int r = 0; r < kBM; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

    for (int kc0 = 0; kc0 < K; kc0 += kKC) {
      const int kn = min(kKC, K - kc0);
      __syncthreads();                        // smem free to overwrite
      for (int i = tid; i < kBM * kn; i += kThreads) {
        const int r = i / kn, kk = i - r * kn;
        smem[r * kKC + kk] =
            r < nrows ? to_f32(xe[(size_t)(r0 + r) * K + kc0 + kk]) : 0.f;
      }
      __syncthreads();
      if (col_ok) {
#pragma unroll 4
        for (int kk = ks; kk < kn; kk += kSlices) {
          float wv[kCols];
          load8(we + (size_t)(kc0 + kk) * N + col, wv);
#pragma unroll
          for (int r = 0; r < kBM; ++r) {
            if (r < nrows) {
              const float a = smem[r * kKC + kk];
#pragma unroll
              for (int c = 0; c < kCols; ++c)
                acc[r][c] = fmaf(a, wv[c], acc[r][c]);
            }
          }
        }
      }
    }
    // lanes l and l ^ 16 hold the same columns for k-slices 2w and 2w+1
#pragma unroll
    for (int r = 0; r < kBM; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[r][c] += __shfl_xor_sync(kFull, acc[r][c], 16);
    __syncthreads();                          // x chunk reads done
    if (lane < 16) {
#pragma unroll
      for (int r = 0; r < kBM; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          smem[(warp * kBM + r) * kBN + cg * kCols + c] = acc[r][c];
    }
    __syncthreads();
    for (int o = tid; o < kBM * kBN; o += kThreads) {
      const int r = o / kBN, cc = o - r * kBN;
      if (r0 + r < C && n0 + cc < N) {
        float s = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) s += smem[(wp * kBM + r) * kBN + cc];
        store(oe + (size_t)(r0 + r) * N + n0 + cc, r < nrows ? s : 0.f);
      }
    }
  }
  // rows from the first one no tile covered to C: exact zeros
  for (int o = tid; o < (C - r0) * kBN; o += kThreads) {
    const int r = r0 + o / kBN, cc = o % kBN;
    if (n0 + cc < N) store(oe + (size_t)r * N + n0 + cc, 0.f);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`.  dtype 0 = fp32, 1 = bf16 (x, w and out alike); the
// caller has checked N % 8 == 0.  Returns the cudaError_t of the launch
// (0 on success).
int grouped_gemm_launch(const void* x, const void* w, const int* group_len,
                        void* out, int E, int C, int K, int N, int dtype,
                        void* stream) {
  if (E <= 0 || C <= 0 || N <= 0) return 0;
  if (N % kCols != 0 || E > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, E);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    grouped_gemm_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)w, group_len, (float*)out, C, K, N);
  } else if (dtype == 1) {
    grouped_gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, group_len,
        (__nv_bfloat16*)out, C, K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* grouped_gemm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
