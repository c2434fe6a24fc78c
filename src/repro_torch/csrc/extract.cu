// Padded sub-grid extraction for Hopper (sm_90a): the per-task view of an
// assembled level, each sub-grid with its ghost band, written in one pass
// straight from the level.
//
//   src (F, M, M, M), any strides  ->  out (G^3, F, P, P, P), contiguous
//
// P = S + 2g.  Slot s = (gx * G + gy) * G + gz holds, per field, the cells
// [gx * S - o, gx * S - o + P) along x of src (y and z alike), where
//   boundary 0 (padded):   src carries its ghost band already, M = G*S + 2g
//                          and o = 0 (the AMR fine level after its ghosts
//                          are prolongated);
//   boundary 1 (outflow):  src is the level itself, M = G*S and o = g; an
//                          index outside [0, M) is clamped into it (F.pad's
//                          "replicate");
//   boundary 2 (periodic): the same, wrapped by M (F.pad's "circular"; the
//                          wrapper checks g <= M).
// g = 0 gives the sub-grids' interiors.  It replaces no TPU kernel: the
// reference pads with jnp.pad and gathers with XLA.  It replaces the torch
// path of hydro/state.py (F.pad's padded copy of the whole level, then
// unfold/permute/reshape's copy into the slots) and is bit-equal to it:
// every element is copied as raw bits, never computed.
//
// What bounds it on an H100: device memory, the bytes written, F * P^3
// per slot (54,880 B at S = 8, g = 3, F = 5; 224.8 MB for 4,096 slots),
// and src read once (41.9 MB): ~0.08 ms at 3.35 TB/s.  Each cell of src is
// read (P / S)^3 times (5.36 at S = 8, g = 3), from L2 after its first
// read: neighbouring slots run in neighbouring blocks at about the same
// time.  Measured (H100 SXM, 700 W): 0.120 ms at 4,096 slots of 14^3,
// 0.925 ms at 32,768; a write-only kernel of 16-byte stores takes 0.081
// and 0.572.
//
// The design:
//  * One block per slot of P * R threads, R = 256 / P (252 at P = 14).
//    Thread t loads the elements t, t + P*R, ... of the slot's contiguous
//    run of out, so a warp's loads touch two or three rows of src.
//  * The block first tabulates in shared memory where each of the slot's
//    F * P^2 rows (f, x, y) starts in src, ghosts placed (3,920 B at
//    P = 14); thread t keeps one z (k = t % P, placed once) and steps R
//    rows per element, so an element costs a shared load, an add and its
//    global load.
//  * A pass loads kUnroll elements per thread, all issued before any is
//    used, into a shared-memory stage of the pass's kUnroll * P * R
//    elements (8,064 B at P = 14), which the block then stores 16 bytes a
//    thread: a warp writes 512 contiguous bytes.  (Measured: 14% faster
//    than each thread storing its own elements.)  Where a slot's run is not
//    a multiple of 16 bytes, or out is not 16-byte aligned, each thread
//    stores its own elements, with no stage.
//  * Offsets are 32-bit where src spans fewer than 2^31 elements (every
//    level a card holds at fp32 below 8 GB), else 64-bit.
//  * Elements are moved as unsigned integers of their size (2, 4 or 8
//    bytes): any dtype of those sizes, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ int place(int x, int m, int boundary) {
  if (boundary == 1) return x < 0 ? 0 : (x >= m ? m - 1 : x);
  if (boundary == 2) return x < 0 ? x + m : (x >= m ? x - m : x);
  return x;
}

// T: the element's bits; I: the offset type (int or long long); kVec:
// the pass's elements are staged in shared memory and stored 16 bytes at a
// time (out and every slot 16-byte aligned), else each thread stores its
// own elements
template <typename T, typename I, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
extract_kernel(const T* __restrict__ src, T* __restrict__ out, int G, int S,
               int P, int F, int off, int boundary, int m, I sf, I sx, I sy,
               I sz) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_rows = F * P * P;
  const int stride = blockDim.x;           // R * P
  const int pass = kUnroll * stride;       // elements a pass writes
  T* stage = reinterpret_cast<T*>(smem);   // kVec: the pass's elements
  I* rows = reinterpret_cast<I*>(smem + (kVec ? pass * sizeof(T) : 0));
  const int slot = blockIdx.x;
  const int gz = slot % G, gy = (slot / G) % G, gx = slot / (G * G);
  const int t = threadIdx.x;
  for (int r = t; r < n_rows; r += stride) {
    const int j = r % P, i = (r / P) % P, f = r / (P * P);
    rows[r] = f * sf + (I)place(gx * S - off + i, m, boundary) * sx +
              (I)place(gy * S - off + j, m, boundary) * sy;
  }
  __syncthreads();
  const int R = stride / P;                // rows a pass of the block steps
  const I zoff = (I)place(gz * S - off + t % P, m, boundary) * sz;
  const long long n = (long long)n_rows * P;
  T* base = out + slot * n;
  for (long long done = 0; done < n; done += pass) {
    const int row = (int)(done / P) + t / P;
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (row + u * R < n_rows) v[u] = __ldg(src + rows[row + u * R] + zoff);
    if (!kVec) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (row + u * R < n_rows) base[done + u * stride + t] = v[u];
      continue;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) stage[u * stride + t] = v[u];
    __syncthreads();
    const int here = (int)min((long long)pass, n - done);
    constexpr int kPer = 16 / sizeof(T);
    uint4* to = reinterpret_cast<uint4*>(base + done);
    const uint4* from = reinterpret_cast<const uint4*>(stage);
    for (int q = t; q < here / kPer; q += stride) to[q] = from[q];
    for (int e = here / kPer * kPer + t; e < here; e += stride)
      base[done + e] = stage[e];
    __syncthreads();
  }
}

template <typename T, typename I>
cudaError_t launch(const void* src, void* out, int G, int S, int P, int F,
                   int off, int boundary, int m, long long sf, long long sx,
                   long long sy, long long sz, cudaStream_t st) {
  const unsigned blocks = (unsigned)G * G * G;
  const int threads = (kMaxThreads / P) * P;
  const bool vec = (long long)F * P * P * P * sizeof(T) % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const size_t table = sizeof(I) * F * P * P;
  const size_t smem = table + (vec ? sizeof(T) * kUnroll * threads : 0);
  if (threads == 0 || smem > 48 * 1024) return cudaErrorInvalidValue;
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  if (vec)
    extract_kernel<T, I, true><<<blocks, threads, smem, st>>>(
        s, o, G, S, P, F, off, boundary, m, (I)sf, (I)sx, (I)sy, (I)sz);
  else
    extract_kernel<T, I, false><<<blocks, threads, smem, st>>>(
        s, o, G, S, P, F, off, boundary, m, (I)sf, (I)sx, (I)sy, (I)sz);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(bool wide, const void* src, void* out, int G, int S,
                     int P, int F, int off, int boundary, int m, long long sf,
                     long long sx, long long sy, long long sz,
                     cudaStream_t st) {
  if (wide)
    return launch<T, long long>(src, out, G, S, P, F, off, boundary, m, sf,
                                sx, sy, sz, st);
  return launch<T, int>(src, out, G, S, P, F, off, boundary, m, sf, sx, sy,
                        sz, st);
}

}  // namespace

extern "C" {

// Launch on `stream`: G^3 blocks of (256 / P) * P threads, each with
// F * P^2 row offsets of shared memory and the pass's stage.  `elem_bytes`
// is 2, 4 or 8; strides are in elements (non-negative); `boundary` as
// above (0 padded, 1 outflow, 2 periodic).  Returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue for an element size or a
// boundary the kernel does not take, P > 256, or shared memory above
// 48 KB).
int extract_launch(const void* src, void* out, int elem_bytes, int G, int S,
                   int g, int F, int boundary, int m, long long sf,
                   long long sx, long long sy, long long sz, void* stream) {
  if (G <= 0 || F <= 0) return 0;
  if (boundary < 0 || boundary > 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int P = S + 2 * g;
  const int off = boundary == 0 ? 0 : g;
  const long long span =
      (F - 1) * sf + (long long)(m - 1) * (sx + sy + sz) + 1;
  const bool wide = span >= (1LL << 31);
  switch (elem_bytes) {
    case 2:
      return (int)launch_t<uint16_t>(wide, src, out, G, S, P, F, off,
                                     boundary, m, sf, sx, sy, sz, st);
    case 4:
      return (int)launch_t<uint32_t>(wide, src, out, G, S, P, F, off,
                                     boundary, m, sf, sx, sy, sz, st);
    case 8:
      return (int)launch_t<unsigned long long>(wide, src, out, G, S, P, F,
                                               off, boundary, m, sf, sx, sy,
                                               sz, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* extract_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
