// Per-sub-grid gravity solve for Hopper (sm_90a): n_iter Jacobi sweeps of
// laplace(phi) = 4 pi G rho on each padded sub-grid, zero on its one-cell
// frame, then the central-difference field g = -grad(phi), over a bucket of
// aggregated slots.
//
//   u (n, 5, P, P, P) fp32, h_slots (n,) fp32  ->  out (n, 4, S, S, S) fp32
//
// out is [phi, gx, gy, gz] over the interior.  Only field 0 (density) is
// read.  Replaces the TPU kernel
// src/repro/kernels/gravity.py::_kernel_gravity_slot_grid_h.
//
// What bounds it on an H100: latency, not bytes or operations.  A 512-slot
// launch moves about 9.8 MB (~2.9 us at 3.35 TB/s) and does about 45 MFLOP
// (~0.7 us at 67 TFLOP/s), but each slot is a chain of n_iter dependent
// sweeps, each a stencil, a subtraction and an IEEE division per cell, with
// a block barrier between sweeps.
//
// The design:
//  * One block of kThreads = 1024 threads per slot.  Thread t owns the
//    cells t, t + 1024, ... of the (P - 2)^3 off the frame (x slowest);
//    their index and right-hand side stay in registers for every sweep.
//    The kernel is instantiated for kCellsSmall = 2 and kCellsLarge = 16
//    cells per thread, and the launch takes the smaller that covers the
//    slot: 2 up to P = 14 (S = 8), 16 up to P = 27.  All density loads are
//    issued before the first barrier.
//  * Registers: __launch_bounds__(1024, 2) holds kCellsSmall to 32, so two
//    blocks share an SM; kCellsLarge takes one block per SM.
//  * Shared memory: a ping-pong pair of phi arrays over the padded slot,
//    2 x P^3 floats (21,952 B at S=8), zeroed once.  Only cells off the
//    frame are ever written, so the frame stays 0 and every neighbour of
//    such a cell is a direct index: the reference's roll never wraps onto
//    a value that is read.
//  * The first sweep starts from phi = 0, where the reference's neighbour
//    sum is +0, so it reads no neighbours: (0 - rhs) / 6.  Each sweep reads
//    one array and writes the other, then one __syncthreads.
//
// Invariants:
//  * The reference's arithmetic order: rhs = (c * rho) * (h * h) with
//    c = 4 pi g_const rounded to fp32 once; nb summed x-1, x+1, y-1, y+1,
//    z-1, z+1 left to right; (nb - rhs) / 6 as an IEEE division; the
//    gradient (phi[i-1] - phi[i+1]) * (0.5 / h).  No multiply-add can be
//    contracted, and the build has no --use_fast_math, so the result is the
//    plain version's bit for bit.
//  * No reduction crosses slots, so a slot's result does not depend on the
//    bucket it was launched in, nor on the instance.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kFields = 5;
constexpr int kThreads = 1024;
constexpr int kCellsSmall = 2;    // cells per thread, two blocks per SM
constexpr int kCellsLarge = 16;   // cells per thread, one block per SM

template <int kCells>
__global__ void __launch_bounds__(kThreads, kCells == kCellsSmall ? 2 : 1)
gravity_kernel(const float* __restrict__ u, const float* __restrict__ h_slots,
               float c, int n_iter, float* __restrict__ out, int S, int G) {
  extern __shared__ float smem[];
  const int P = S + 2 * G, P2 = P * P, P3 = P2 * P, M = P - 2, M2 = M * M;
  const size_t slot = blockIdx.x;
  const float h = h_slots[slot];
  const float hh = h * h;
  const float* rho = u + slot * kFields * (size_t)P3;  // field 0
  for (int i = threadIdx.x; i < 2 * P3; i += kThreads) smem[i] = 0.f;

  // this thread's cells: index into a phi array and right-hand side
  int at[kCells];
  float rhs[kCells];
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int j = threadIdx.x + k * kThreads;
    at[k] = -1;
    rhs[k] = 0.f;
    if (j < M * M2) {
      const int x = 1 + j / M2, y = 1 + (j / M) % M, z = 1 + j % M;
      at[k] = x * P2 + y * P + z;
      rhs[k] = (c * rho[at[k]]) * hh;
    }
  }
  __syncthreads();

  float* phi = smem;
  float* nxt = smem + P3;
  int it = 0;
  if (n_iter > 0) {
    // phi = 0: the neighbour sum is +0
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      if (at[k] < 0) break;
      nxt[at[k]] = (0.0f - rhs[k]) / 6.0f;
    }
    __syncthreads();
    phi = smem + P3;
    nxt = smem;
    it = 1;
  }
  for (; it < n_iter; ++it) {
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int i = at[k];
      if (i < 0) break;
      const float nb = phi[i - P2] + phi[i + P2] + phi[i - P] + phi[i + P] +
                       phi[i - 1] + phi[i + 1];
      nxt[i] = (nb - rhs[k]) / 6.0f;
    }
    __syncthreads();
    float* t = phi;
    phi = nxt;
    nxt = t;
  }

  const float inv2h = 0.5f / h;
  const int S2 = S * S, S3 = S2 * S;
  float* dst = out + slot * 4 * (size_t)S3;
  for (int ci = threadIdx.x; ci < S3; ci += kThreads) {
    const int z = ci % S, y = (ci / S) % S, x = ci / S2;
    const int i = (G + x) * P2 + (G + y) * P + (G + z);
    dst[ci] = phi[i];
    dst[S3 + ci] = (phi[i - P2] - phi[i + P2]) * inv2h;
    dst[2 * S3 + ci] = (phi[i - P] - phi[i + P]) * inv2h;
    dst[3 * S3 + ci] = (phi[i - 1] - phi[i + 1]) * inv2h;
  }
}

template <int kCells>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(gravity_kernel<kCells>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int kCells>
cudaError_t launch(const float* u, const float* h_slots, float* out, int n,
                   int S, int G, float c, int n_iter, cudaStream_t stream) {
  const int P = S + 2 * G;
  gravity_kernel<kCells><<<n, kThreads, 2 * sizeof(float) * P * P * P,
                           stream>>>(u, h_slots, c, n_iter, out, S, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: allow every instance of
// the kernel the device's opt-in shared memory.  Returns a cudaError_t.
int gravity_init(void) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem<kCellsSmall>(optin);
  if (err != cudaSuccess) return (int)err;
  return (int)allow_smem<kCellsLarge>(optin);
}

// Launch on `stream`: n blocks of 1024 threads, each with 2 x P^3 floats of
// shared memory and the smaller instance whose cells per thread cover the
// slot.  `c` is 4 pi g_const rounded once to fp32.  Returns the cudaError_t
// of the launch (0 on success; cudaErrorInvalidValue where (P - 2)^3 cells
// exceed 1024 x kCellsLarge, P > 27).
int gravity_launch(const float* u, const float* h_slots, float* out, int n,
                   int S, int G, float c, int n_iter, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int M = S + 2 * G - 2;
  const int need = (M * M * M + kThreads - 1) / kThreads;
  if (need <= kCellsSmall)
    return (int)launch<kCellsSmall>(u, h_slots, out, n, S, G, c, n_iter, st);
  if (need <= kCellsLarge)
    return (int)launch<kCellsLarge>(u, h_slots, out, n, S, G, c, n_iter, st);
  return (int)cudaErrorInvalidValue;
}

const char* gravity_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
