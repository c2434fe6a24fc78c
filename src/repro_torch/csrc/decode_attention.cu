// Flash-decode GQA attention for Hopper (sm_90a): one new query token per
// request against that request's KV cache, over a bucket of aggregated
// requests of different lengths.
//
//   q (B, Hq, D), k, v (B, S, Hkv, D), cache_len (B,) int32  ->  out (B, Hq, D)
//
// fp32 or bf16 inputs and output; scores, softmax and the accumulator in
// fp32.  Positions >= cache_len[b] are masked, and the tiles beyond it are
// never loaded; cache_len == 0 gives 0 (the accumulator and the denominator
// stay 0, and the denominator is clamped to 1e-30 as in the TPU kernel).
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::_decode_kernel.
//
// What bounds it on an H100: bytes.  Each live cache row is read once
// (sum_b cache_len[b] * Hkv * D * 2 elements of K and V) against 4 operations
// per row, query head and dimension, far below the card's ratio of ~295
// operations per byte; at decode the whole cache of a bucket of 8 requests
// is a few MB per layer, so the launch and the loop's latency set the time.
//
// What the design does about it:
//  * One block per (kv head, request).  It holds the G = Hq / Hkv query rows
//    of that kv head in shared memory, so the group shares every K and V row
//    it loads.  The TPU's sequential grid axis over cache tiles becomes a
//    loop inside the block, carrying the running max, the denominator and
//    the (G, D) accumulator (registers, in fp32).
//  * Per tile of 64 positions: groups of lanes (lanes per position = the
//    next power of two >= D / 8) each load one K row with 16-byte loads and
//    reduce the G dot products by shuffles; one warp per query row then
//    takes the tile's max and exponentials; each thread accumulates P V for
//    its columns (d = thread, thread + 128), reading V rows coalesced.
//  * The loop stops at cache_len[b]: a short request in a bucket never waits
//    for the longest one's tiles.
//  * No value crosses requests, and every sum runs in a fixed order, so a
//    request's result does not depend on the rest of its bucket.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "lm_common.cuh"

namespace {

using lm::load8;
using lm::store;
using lm::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // cache positions per tile
constexpr int kMaxG = 16;          // query rows per kv head
constexpr int kMaxD = 256;         // head dimension
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ cache_len,
                        T* __restrict__ out, int S, int Hkv, int G, int D,
                        float scale) {
  __shared__ __align__(16) float qs[kMaxG * kMaxD];
  __shared__ float sc[kMaxG * kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t Hq = (size_t)Hkv * G;

  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(qb[i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int L = min(max(cache_len[b], 0), S);
  const int n_chunk = D / 8;             // 8-element chunks of a row
  int lp = 1;                            // lanes per position
  while (lp < n_chunk) lp <<= 1;
  const int per_warp = 32 / lp;
  const int n_groups = kWarps * per_warp;
  const int grp = warp * per_warp + lane / lp;
  const int sub = lane % lp;
  const size_t row = (size_t)Hkv * D;    // elements from one position to the next
  const T* kb = k + (size_t)b * S * row + (size_t)h * D;
  const T* vb = v + (size_t)b * S * row + (size_t)h * D;

  float acc[kMaxG][2];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g][0] = acc[g][1] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < L; t0 += kTile) {
    const int nt = min(kTile, L - t0);
    // scores: every lane runs the same trip count, so the shuffles see the
    // whole warp; lanes of a position beyond nt contribute nothing
    for (int p = grp; p < kTile; p += n_groups) {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      if (p < nt && sub < n_chunk) {
        float kv[8];
        load8(kb + (size_t)(t0 + p) * row + sub * 8, kv);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float4* qg =
                reinterpret_cast<const float4*>(qs + g * D + sub * 8);
            const float4 a = qg[0], c = qg[1];
            float s = 0.f;
            s = fmaf(a.x, kv[0], s); s = fmaf(a.y, kv[1], s);
            s = fmaf(a.z, kv[2], s); s = fmaf(a.w, kv[3], s);
            s = fmaf(c.x, kv[4], s); s = fmaf(c.y, kv[5], s);
            s = fmaf(c.z, kv[6], s); s = fmaf(c.w, kv[7], s);
            part[g] = s;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          for (int off = lp >> 1; off > 0; off >>= 1)
            part[g] += __shfl_xor_sync(kFull, part[g], off);
        }
      }
      if (sub == 0) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) sc[g * kTile + p] = p < nt ? part[g] * scale : kNegInf;
      }
    }
    __syncthreads();
    // online softmax: one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = sc[g * kTile + lane], s1 = sc[g * kTile + lane + 32];
      float mx = fmaxf(s0, s1);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = lane < nt ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < nt ? expf(s1 - m_new) : 0.f;
      sc[g * kTile + lane] = p0;
      sc[g * kTile + lane + 32] = p1;
      float sum = p0 + p1;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V, columns tid and tid + 128 of every query row
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float a = alpha_s[g];
        acc[g][0] *= a;
        acc[g][1] *= a;
      }
    }
    const bool c0 = tid < D, c1 = tid + kThreads < D;
#pragma unroll 4
    for (int j = 0; j < nt; ++j) {
      const T* vr = vb + (size_t)(t0 + j) * row;
      const float v0 = c0 ? to_f32(vr[tid]) : 0.f;
      const float v1 = c1 ? to_f32(vr[tid + kThreads]) : 0.f;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float pj = sc[g * kTile + j];
          acc[g][0] = fmaf(pj, v0, acc[g][0]);
          acc[g][1] = fmaf(pj, v1, acc[g][1]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites sc
  }

  T* ob = out + ((size_t)b * Hq + (size_t)h * G) * D;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      const float denom = fmaxf(l_s[g], 1e-30f);
      if (tid < D) store(ob + g * D + tid, acc[g][0] / denom);
      if (tid + kThreads < D)
        store(ob + g * D + tid + kThreads, acc[g][1] / denom);
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`.  dtype 0 = fp32, 1 = bf16 (q, k, v and out alike);
// the caller has checked D % 8 == 0, D <= 256 and G <= 16.  Returns the
// cudaError_t of the launch (0 on success).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* cache_len, void* out, int B, int S,
                            int Hkv, int G, int D, float scale, int dtype,
                            void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  if (D % 8 != 0 || D > kMaxD || G < 1 || G > kMaxG)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    decode_attention_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, cache_len,
        (float*)out, S, Hkv, G, D, scale);
  } else if (dtype == 1) {
    decode_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, cache_len, (__nv_bfloat16*)out, S, Hkv, G,
        D, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
