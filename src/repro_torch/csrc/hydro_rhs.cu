// Fused hydro RHS for Hopper (sm_90a): CW84 PPM reconstruction + KNP
// central-upwind flux at 9 Simpson points per face + flux divergence, over a
// bucket of aggregated padded sub-grids.
//
//   u (n, 5, P, P, P) fp32  ->  out (n, 5, S, S, S) fp32,  P = S + 2*G, G = 3
//
// Replaces the TPU kernels src/repro/kernels/hydro_rhs.py::_kernel_slot_grid
// (static h) and ::_kernel_slot_grid_h (per-slot h_slots): pass h_slots=NULL
// for the scalar width, or one width per slot.
//
// What bounds it on an H100: arithmetic.  The function needs, with every
// distinct value computed once (each PPM interface value, each (pair, cell)
// limiter and each state's primitives, then KNP, weights and divergence per
// face point), about 2.67 MFLOP per slot at S=8 against 54,880 B in and
// 10,240 B out: some 40 operations per byte, above the card's ~20 fp32
// operations per byte of HBM.  A 512-slot bucket is ~1.37 GFLOP (~20 us at
// 67 TFLOP/s) against 33 MB (~10 us at 3.35 TB/s).
//
// What the design does about it:
//  * It evaluates only the faces the divergence consumes, (S+1)*S*S per
//    axis, by direct indexing.  The Pallas kernel rolls whole P^3 arrays and
//    so evaluates every quadrature point at all P^3 cells (4.8x the work at
//    S=8).  Every sample index stays inside [0, P-1] for G=3, so no
//    wrap-around is ever read.
//  * It recomputes both PPM sides at every face point instead of staging
//    the 13 pairs' reconstruction (~2.1x the function's operations, no
//    intermediate storage).  Sharing them is the next step toward the bound.
//  * One block per slot: the padded slot is staged once into dynamic shared
//    memory (each input byte is read from HBM once) and the face fluxes of
//    one axis stay in shared memory (~66 KB per block at S=8, 3 blocks per
//    SM).  The divergence of each axis is added into the output by the
//    thread that owns the cell, in the reference's order (axis 0, 1, 2).
//  * No reduction crosses slots, so a slot's result does not depend on the
//    bucket it was launched in: aggregated launches stay bit-identical to
//    one whole-wave launch.
//  * Arithmetic follows the reference's expression order; built without
//    --use_fast_math, so sqrt and division are IEEE-rounded.
//  * FACE_QUAD lives in constant memory, uploaded once per device by
//    hydro_rhs_init, which also raises the kernel's shared-memory limit.
//  * The device math (PPM side, KNP flux, face and divergence passes) is
//    hydro_common.cuh, shared with the split pair in hydro_split.cu.

#include "hydro_common.cuh"

namespace {

__global__ void __launch_bounds__(kThreads, 3)
hydro_rhs_kernel(const float* __restrict__ u,
                 const float* __restrict__ h_slots, float h, float gamma,
                 float gm1, float* __restrict__ out, int S) {
  extern __shared__ float smem[];
  const int P = S + 2 * kGhost, P3 = P * P * P;
  float* us = smem;
  float* face = smem + kFields * P3;
  const size_t slot = blockIdx.x;
  const float* src = u + slot * kFields * P3;
  for (int i = threadIdx.x; i < kFields * P3; i += kThreads) us[i] = src[i];
  const float hh = h_slots != nullptr ? h_slots[slot] : h;
  float* dst = out + slot * kFields * S * S * S;
  __syncthreads();
  rhs_passes(PpmStates{us, P}, face, dst, P, S, hh, gamma, gm1);
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: upload FACE_QUAD into
// constant memory and allow the kernel the device's opt-in shared memory.
// `weights` is 3 x 9 floats; `table` is 3 x 9 x 8 ints, each entry
// (dir_l x, y, z, plus_l, dir_r x, y, z, plus_r).  Returns a cudaError_t.
int hydro_rhs_init(const float* weights, const int* table) {
  cudaError_t err = upload_quad_table(weights, table, nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)allow_optin_smem(hydro_rhs_kernel);
}

// Launch on `stream`.  `smem` is the dynamic shared memory of one block:
// the padded slot, then one axis' face fluxes, 4 * 5 * (P^3 + (S+1)*S*S)
// bytes (kernels/hydro_rhs.py::smem_bytes).  `gm1` is gamma - 1, rounded
// once from double as the plain version rounds it.  Returns the cudaError_t
// of the launch (0 on success).
int hydro_rhs_launch(const float* u, const float* h_slots, float* out, int n,
                     int S, float h, float gamma, float gm1, size_t smem,
                     void* stream) {
  if (n <= 0) return 0;
  hydro_rhs_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      u, h_slots, h, gamma, gm1, out, S);
  return (int)cudaGetLastError();
}

const char* hydro_rhs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
