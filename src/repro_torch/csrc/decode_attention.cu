// Flash-decode GQA attention for Hopper (sm_90a): one new query token per
// request against that request's KV cache, over a bucket of aggregated
// requests of different lengths, with the cache split over blocks
// (split-KV, "flash-decoding").
//
//   q (B, Hq, D), k, v (B, S, Hkv, D), cache_len (B,) int32  ->  out (B, Hq, D)
//
// fp32 or bf16 inputs and output; scores, softmax and the accumulator in
// fp32.  Positions >= cache_len[b] are masked and never read;
// cache_len == 0 gives 0.  Replaces the TPU kernel
// src/repro/kernels/decode_attention.py::_decode_kernel.
//
// What bounds it on an H100: bytes.  Each live cache row is read once
// (sum_b cache_len[b] * Hkv * D * 2 elements of K and V) against 4
// operations per row, query head and dimension: about 1 operation per byte
// at G = 1, against the ~295 the card's bf16 tensor cores need per byte
// before they, and not the memory, are the limit.  With G <= 16 query rows
// per kv head there is no tile a wgmma could fill (it takes 64 rows), so
// tensor cores buy nothing here; the CUDA cores keep up with the bytes.
//
// What the design does about it:
//  * Split-KV.  The grid is (kv head, request, chunk), a chunk being a
//    fixed number of cache positions chosen from S and D alone
//    (kernels/decode_attention.py::launch_plan), so the launch is sized
//    without reading cache_len on the host.  A chunk at or beyond
//    cache_len[b] exits at once.  At B 8, S 1,024, Hkv 16 and D 128 the
//    plan's 64-position chunks give up to 2,048 blocks in place of 128, so
//    the longest request no longer walks its whole cache in one block.
//    (Measured on the H100 at that shape, PERF.md, PR 15: chunks of 64
//    and 128 positions tie, 32 and 256 are 11% and 36% slower; at
//    granite-8b's GQA 4, 64 is 13% faster than 128.)
//  * Each block holds the G = Hq / Hkv query rows of its kv head in shared
//    memory, so the group shares every K and V row, and runs the online
//    softmax over its chunk tile by tile, writing its running max,
//    denominator and (G, D) fp32 accumulator to a scratch the wrapper
//    allocates.
//  * K and V tiles of 32 positions are staged in shared memory with 16-byte
//    cp.async, double-buffered: tile t+1's copy is in flight while tile t's
//    scores, softmax and P.V run.  Rows past the chunk's end are zero-filled
//    by the copy (source size 0: nothing is read).
//  * Scores: lanes per position (the next power of two >= D / 8) each take
//    8 elements of a K row from shared memory and reduce the G dot products
//    by shuffles.  P.V: each thread owns 8 columns (one 16-byte read of a V
//    row in shared memory per position) and a subset of the tile's
//    positions; the position groups are summed at the end of the chunk,
//    first by shuffles, then over the 4 warps in warp order.
//  * A second kernel, one block per (kv head, request), merges the live
//    chunks in chunk order (max, then rescaled denominators and
//    accumulators), divides, and writes 0 where cache_len == 0.
//  * No value crosses requests, the chunk size depends on S and D only,
//    and every sum runs in a fixed order, so a request's result does not
//    depend on the rest of its bucket, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "lm_common.cuh"

namespace {

using lm::load8;
using lm::store;
using lm::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // cache positions per staged tile
constexpr int kStages = 2;         // tiles in flight per block
constexpr int kMaxG = 16;          // query rows per kv head
constexpr int kMaxD = 256;         // head dimension
constexpr int kMaxChunks = 64;     // chunks per (kv head, request)
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled and nothing read
// when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Dynamic shared memory of one chunk block: the K/V stages (reused for the
// end-of-chunk reduction), the query rows, one tile's scores and the
// running max, denominator and rescale factor.
__host__ __device__ inline size_t stage_bytes(int G, int D, int elt) {
  const size_t st = (size_t)kStages * 2 * kTile * D * elt;
  const size_t red = (size_t)kWarps * G * D * 4;
  return st > red ? st : red;
}
__host__ __device__ inline size_t chunk_smem_bytes(int G, int D, int elt) {
  return stage_bytes(G, D, elt) + (size_t)G * D * 4 + (size_t)G * kTile * 4 +
         3 * kMaxG * 4;
}

// One (kv head, request, chunk): the online softmax over positions
// [c * chunk, min((c + 1) * chunk, cache_len[b])), written to the scratch
// as (m, l) per query row and the unnormalised (G, D) accumulator.
template <typename T, int KG>
__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int* __restrict__ cache_len,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int S, int Hkv, int G, int D, int chunk, int n_chunks,
                    float scale) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int h = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int L = min(max(cache_len[b], 0), S);
  const int start = c * chunk;
  if (start >= L) return;
  const int end = min(start + chunk, L);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int elt = (int)sizeof(T);
  T* stage = reinterpret_cast<T*>(dsm);
  float* red = reinterpret_cast<float*>(dsm);     // after the tile loop
  float* qs = reinterpret_cast<float*>(dsm + stage_bytes(G, D, elt));
  float* sc = qs + G * D;
  float* m_s = sc + G * kTile;
  float* l_s = m_s + kMaxG;
  float* alpha_s = l_s + kMaxG;
  const int tile_elems = kTile * D;               // one K or V tile

  const size_t Hq = (size_t)Hkv * G;
  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(qb[i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const size_t row = (size_t)Hkv * D;  // elements from one position to the next
  const T* kb = k + (size_t)b * S * row + (size_t)h * D;
  const T* vb = v + (size_t)b * S * row + (size_t)h * D;

  // stage tile t (positions start + t * kTile ...) into buffer t % 2
  const int vec = 16 / elt;            // elements per 16-byte copy
  const int per_row = D / vec;
  auto load_tile = [&](int t) {
    T* ks = stage + (size_t)(t & 1) * 2 * tile_elems;
    T* vs = ks + tile_elems;
    const int p0 = start + t * kTile;
    for (int i = tid; i < kTile * per_row; i += kThreads) {
      const int r = i / per_row, col = (i - r * per_row) * vec;
      const int p = p0 + r;
      const bool ok = p < end;
      const size_t off = (size_t)(ok ? p : start) * row + col;
      cp_async16(ks + r * D + col, kb + off, ok);
      cp_async16(vs + r * D + col, vb + off, ok);
    }
    cp_async_commit();
  };

  const int n8 = D / 8;                  // 8-element pieces of a row
  int lp = 1;                            // lanes per position
  while (lp < n8) lp <<= 1;
  const int per_warp = 32 / lp;
  const int n_groups = kWarps * per_warp;
  const int grp = warp * per_warp + lane / lp;
  const int sub = lane % lp;

  float acc[KG][8];
#pragma unroll
  for (int g = 0; g < KG; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;

  const int n_tiles = (end - start + kTile - 1) / kTile;
  load_tile(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = stage + (size_t)(t & 1) * 2 * tile_elems;
    const T* vs = ks + tile_elems;
    const int nt = min(kTile, end - (start + t * kTile));

    // scores: every lane runs the same trip count, so the shuffles see the
    // whole warp; lanes of a position beyond nt contribute nothing
    for (int p = grp; p < kTile; p += n_groups) {
      float part[KG];
#pragma unroll
      for (int g = 0; g < KG; ++g) part[g] = 0.f;
      if (p < nt && sub < n8) {
        float kv[8];
        load8(ks + p * D + sub * 8, kv);
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (g < G) {
            const float4* qg =
                reinterpret_cast<const float4*>(qs + g * D + sub * 8);
            const float4 a = qg[0], cc = qg[1];
            float s = 0.f;
            s = fmaf(a.x, kv[0], s); s = fmaf(a.y, kv[1], s);
            s = fmaf(a.z, kv[2], s); s = fmaf(a.w, kv[3], s);
            s = fmaf(cc.x, kv[4], s); s = fmaf(cc.y, kv[5], s);
            s = fmaf(cc.z, kv[6], s); s = fmaf(cc.w, kv[7], s);
            part[g] = s;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        if (g < G) {
          for (int off = lp >> 1; off > 0; off >>= 1)
            part[g] += __shfl_xor_sync(kFull, part[g], off);
        }
      }
      if (sub == 0) {
#pragma unroll
        for (int g = 0; g < KG; ++g)
          if (g < G) sc[g * kTile + p] = p < nt ? part[g] * scale : kNegInf;
      }
    }
    __syncthreads();
    // online softmax over the tile: one warp per query row, a lane per
    // position
    for (int g = warp; g < G; g += kWarps) {
      const float s = sc[g * kTile + lane];
      float mx = s;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float pr = lane < nt ? expf(s - m_new) : 0.f;
      sc[g * kTile + lane] = pr;
      float sum = pr;
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
    // acc = acc * alpha + P V over this thread's 8 columns and positions
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      if (g < G) {
        const float a = alpha_s[g];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= a;
      }
    }
    if (sub < n8) {
      for (int j = grp; j < nt; j += n_groups) {
        float vv[8];
        load8(vs + j * D + sub * 8, vv);
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (g < G) {
            const float pj = sc[g * kTile + j];
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pj, vv[e], acc[g][e]);
          }
        }
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

  // sum the position groups: within a warp by shuffles, then over the
  // warps in warp order through shared memory (the stages are free now)
  for (int off = lp; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < KG; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], off);
  }
  if (lane < lp && sub < n8) {
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      if (g < G) {
        float* r = red + ((size_t)warp * G + g) * D + sub * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) r[e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  const size_t slot = ((size_t)b * Hkv + h) * n_chunks + c;
  float* pa = part_acc + slot * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    float a = red[i];
    for (int w = 1; w < kWarps; ++w) a += red[(size_t)w * G * D + i];
    pa[i] = a;
  }
  if (tid < G) {
    part_ml[(slot * G + tid) * 2] = m_s[tid];
    part_ml[(slot * G + tid) * 2 + 1] = l_s[tid];
  }
}

// One (kv head, request): merge the live chunks in chunk order and divide;
// cache_len == 0 gives 0 (the TPU kernel's result).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ cache_len, T* __restrict__ out,
                      int S, int Hkv, int G, int D, int chunk, int n_chunks) {
  __shared__ float wgt[kMaxChunks * kMaxG];
  __shared__ float denom[kMaxG];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int L = min(max(cache_len[b], 0), S);
  const int live = (L + chunk - 1) / chunk;
  T* ob = out + ((size_t)b * Hkv * G + (size_t)h * G) * D;
  if (live == 0) {
    for (int i = tid; i < G * D; i += kThreads) store(ob + i, 0.f);
    return;
  }
  const size_t base = ((size_t)b * Hkv + h) * n_chunks;
  if (tid < G) {
    float m = kNegInf;
    for (int c = 0; c < live; ++c)
      m = fmaxf(m, part_ml[((base + c) * G + tid) * 2]);
    float l = 0.f;
    for (int c = 0; c < live; ++c) {
      const float* ml = part_ml + ((base + c) * G + tid) * 2;
      const float w = expf(ml[0] - m);
      wgt[c * G + tid] = w;
      l = l + ml[1] * w;
    }
    denom[tid] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float a = 0.f;
    for (int c = 0; c < live; ++c)
      a = a + part_acc[(base + c) * G * D + i] * wgt[c * G + g];
    store(ob + i, a / denom[g]);
  }
}

template <typename T, int KG>
cudaError_t allow_smem() {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(decode_chunk_kernel<T, KG>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin);
}

template <typename T>
cudaError_t allow_smem_all() {
  cudaError_t err = allow_smem<T, 1>();
  if (err == cudaSuccess) err = allow_smem<T, 4>();
  if (err == cudaSuccess) err = allow_smem<T, 16>();
  return err;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cache_len, void* out, float* part_acc,
                   float* part_ml, int B, int S, int Hkv, int G, int D,
                   int chunk, int n_chunks, float scale, cudaStream_t s) {
  const dim3 grid(Hkv, B, n_chunks);
  const size_t smem = chunk_smem_bytes(G, D, (int)sizeof(T));
  const T* qt = (const T*)q;
  const T* kt = (const T*)k;
  const T* vt = (const T*)v;
  if (G <= 1) {
    decode_chunk_kernel<T, 1><<<grid, kThreads, smem, s>>>(
        qt, kt, vt, cache_len, part_acc, part_ml, S, Hkv, G, D, chunk,
        n_chunks, scale);
  } else if (G <= 4) {
    decode_chunk_kernel<T, 4><<<grid, kThreads, smem, s>>>(
        qt, kt, vt, cache_len, part_acc, part_ml, S, Hkv, G, D, chunk,
        n_chunks, scale);
  } else {
    decode_chunk_kernel<T, 16><<<grid, kThreads, smem, s>>>(
        qt, kt, vt, cache_len, part_acc, part_ml, S, Hkv, G, D, chunk,
        n_chunks, scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(Hkv, B), kThreads, 0, s>>>(
      part_acc, part_ml, cache_len, (T*)out, S, Hkv, G, D, chunk, n_chunks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: allow the chunk kernels
// the device's opt-in shared memory (fp32 at D 256 and G 16 stages
// ~150 KB).  Returns a cudaError_t.
int decode_attention_init() {
  cudaError_t err = allow_smem_all<float>();
  if (err == cudaSuccess) err = allow_smem_all<__nv_bfloat16>();
  return (int)err;
}

// Launch the chunk kernel and the combine kernel on `stream`.  dtype 0 =
// fp32, 1 = bf16 (q, k, v and out alike); `chunk` positions per block, a
// multiple of 32, with n_chunks = ceil(S / chunk) <= 64; `part_acc` holds
// B * Hkv * n_chunks * G * D floats and `part_ml` B * Hkv * n_chunks * G * 2.
// The caller has checked D % 8 == 0, D <= 256, G <= 16 and 16-byte
// alignment.  Returns the cudaError_t of the launches (0 on success).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* cache_len, void* out, void* part_acc,
                            void* part_ml, int B, int S, int Hkv, int G,
                            int D, int chunk, float scale, int dtype,
                            void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  if (D % 8 != 0 || D > kMaxD || G < 1 || G > kMaxG || chunk < kTile ||
      chunk % kTile != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (S + chunk - 1) / chunk;
  if (n_chunks > kMaxChunks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* pa = (float*)part_acc;
  float* pm = (float*)part_ml;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, cache_len, out, pa, pm, B, S, Hkv, G,
                              D, chunk, n_chunks, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, cache_len, out, pa, pm, B, S,
                                      Hkv, G, D, chunk, n_chunks, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
