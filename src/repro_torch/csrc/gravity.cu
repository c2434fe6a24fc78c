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
// What bounds it on an H100: bytes, by far.  A 512-slot launch reads
// 512 x (10,976 B of density + 4 B of h) and writes 512 x 8,192 B, about
// 9.8 MB (~2.9 us at 3.35 TB/s), against about 0.1 MFLOP per slot (~0.8 us
// at 67 TFLOP/s).  At that size the launch itself, not either bound, is
// expected to set the time.
//
// What the design does about it:
//  * One block per slot.  The right-hand side and a ping-pong pair of phi
//    arrays live in shared memory (3 x P^3 floats, 32,928 B at S=8); the
//    density is read from device memory once and the result written once.
//  * Every neighbour of an interior cell lies in [0, P-1], so the
//    reference's roll is direct indexing and its wrap-around is never
//    read.  The frame stays 0 in both arrays.
//  * The reference's arithmetic order: rhs = (c * rho) * (h * h) with
//    c = 4 pi g_const rounded to fp32 once; nb summed x-1, x+1, y-1, y+1,
//    z-1, z+1 left to right; (nb - rhs) / 6 as an IEEE division; the
//    gradient (phi[i-1] - phi[i+1]) * (0.5 / h).  No multiply-add can be
//    contracted, and the build has no --use_fast_math.
//  * No reduction crosses slots, so a slot's result does not depend on the
//    bucket it was launched in.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kFields = 5;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gravity_kernel(const float* __restrict__ u, const float* __restrict__ h_slots,
               float c, int n_iter, float* __restrict__ out, int S, int G) {
  extern __shared__ float smem[];
  const int P = S + 2 * G, P2 = P * P, P3 = P2 * P;
  float* rhs = smem;
  float* phi = smem + P3;
  float* nxt = smem + 2 * P3;
  const size_t slot = blockIdx.x;
  const float h = h_slots[slot];
  const float hh = h * h;
  const float* rho = u + slot * kFields * P3;     // field 0 of the slot
  for (int i = threadIdx.x; i < P3; i += kThreads) {
    rhs[i] = (c * rho[i]) * hh;
    phi[i] = 0.f;
    nxt[i] = 0.f;
  }
  __syncthreads();
  const int M = P - 2;                            // cells off the frame
  const int M3 = M * M * M;
  for (int it = 0; it < n_iter; ++it) {
    for (int j = threadIdx.x; j < M3; j += kThreads) {
      const int z = 1 + j % M, y = 1 + (j / M) % M, x = 1 + j / (M * M);
      const int i = x * P2 + y * P + z;
      const float nb = phi[i - P2] + phi[i + P2] + phi[i - P] + phi[i + P] +
                       phi[i - 1] + phi[i + 1];
      nxt[i] = (nb - rhs[i]) / 6.0f;
    }
    __syncthreads();
    float* t = phi;
    phi = nxt;
    nxt = t;
  }
  const float inv2h = 0.5f / h;
  const int S3 = S * S * S;
  float* dst = out + slot * 4 * S3;
  for (int ci = threadIdx.x; ci < S3; ci += kThreads) {
    const int z = ci % S, y = (ci / S) % S, x = ci / (S * S);
    const int i = (G + x) * P2 + (G + y) * P + (G + z);
    dst[ci] = phi[i];
    dst[S3 + ci] = (phi[i - P2] - phi[i + P2]) * inv2h;
    dst[2 * S3 + ci] = (phi[i - P] - phi[i + P]) * inv2h;
    dst[3 * S3 + ci] = (phi[i - 1] - phi[i + 1]) * inv2h;
  }
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: allow the kernel the
// device's opt-in shared memory (sub-grids above S=10 need more than the
// 48 KB default).  Returns a cudaError_t.
int gravity_init(void) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      gravity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
}

// Launch on `stream`.  `c` is 4 pi g_const rounded once to fp32; `smem` is
// 3 * 4 * P^3 bytes (kernels/gravity.py::smem_bytes).  Returns the
// cudaError_t of the launch (0 on success).
int gravity_launch(const float* u, const float* h_slots, float* out, int n,
                   int S, int G, float c, int n_iter, size_t smem,
                   void* stream) {
  if (n <= 0) return 0;
  gravity_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      u, h_slots, c, n_iter, out, S, G);
  return (int)cudaGetLastError();
}

const char* gravity_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
