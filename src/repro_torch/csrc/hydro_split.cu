// The paper's two-kernel hydro structure for Hopper (sm_90a): Reconstruct
// writes every PPM surface value of a bucket of padded sub-grids to device
// memory, and Flux reads them back for the KNP flux and its divergence.
//
//   reconstruct: u (n, 5, P, P, P)            -> recon (n, 13, 2, 5, P, P, P)
//   flux:        recon (n, 13, 2, 5, P, P, P) -> out (n, 5, S, S, S)
//
// fp32, P = S + 2*G, G = 3.  recon is [pair][side][field][x][y][z] in
// DIR_PAIRS order; side 0 is the value toward -d, side 1 toward +d.
//
// Replaces the TPU kernels src/repro/kernels/hydro_rhs.py::_kernel_reconstruct
// and ::_kernel_flux.  The fused kernel (hydro_rhs.cu) computes the same
// function in one launch; this pair exists as the paper's original GPU
// structure and as the yardstick of what staging the reconstruction costs.
//
// What bounds them on an H100: bytes.
//  * Reconstruct writes 26 values per field and cell, every cell of the
//    padded block: 1,426,880 B per slot at S=8 against 54,880 B read, a
//    few operations per byte.  512 slots move 759 MB: ~0.23 ms at 3.35 TB/s.
//  * Flux reads, of those, only the distinct (pair, side, field, cell)
//    values its consumed faces need (kernels/hydro_split.py::
//    flux_read_states counts them): 335,360 B per slot, 171.7 MB at 512
//    slots, with 5.2 MB out (~0.053 ms).  Its operations are the fused
//    kernel's minus the reconstruction, about 0.74 GFLOP at 512 slots
//    (~0.011 ms), so bytes bound it too.
//
// What the design does about it:
//  * Reconstruct: one block per slot, the slot staged once in shared
//    memory (54,880 B, opt-in), and each thread stores one cell of one
//    (pair, field) plane per step, so stores are coalesced along z.  Both
//    sides of a pair come from one set of five samples.  Indices wrap mod
//    P as torch.roll does, so the frame values equal the plain version's
//    and no output element is left unwritten.
//  * Flux: one block per slot runs the fused kernel's face and divergence
//    passes (hydro_common.cuh) with each state read from the staged
//    reconstruction instead of recomputed: only the consumed faces, with
//    one axis' face fluxes in shared memory (11,520 B at S=8).
//  * No reduction crosses slots, so a slot's result does not depend on the
//    bucket it was launched in.
//  * Built without --use_fast_math: sqrt and division are IEEE-rounded.

#include "hydro_common.cuh"

namespace {

constexpr int kReconThreads = 256;

__device__ __forceinline__ int wrap(int i, int P) {
  return i < 0 ? i + P : (i >= P ? i - P : i);
}

__global__ void __launch_bounds__(kReconThreads)
reconstruct_kernel(const float* __restrict__ u, float* __restrict__ out,
                   int P) {
  extern __shared__ float us[];
  const int P2 = P * P, P3 = P2 * P;
  const size_t slot = blockIdx.x;
  const float* src = u + slot * kFields * P3;
  for (int i = threadIdx.x; i < kFields * P3; i += kReconThreads)
    us[i] = src[i];
  __syncthreads();
  float* dst = out + slot * (size_t)kPairs * 2 * kFields * P3;
  for (int pair = 0; pair < kPairs; ++pair) {
    const int dx = c_tab.dirs[pair][0], dy = c_tab.dirs[pair][1],
              dz = c_tab.dirs[pair][2];
    float* lo = dst + (size_t)(pair * 2) * kFields * P3;
    float* hi = lo + (size_t)kFields * P3;
    for (int c = threadIdx.x; c < P3; c += kReconThreads) {
      const int z = c % P, y = (c / P) % P, x = c / P2;
      int at[5];
#pragma unroll
      for (int k = -2; k <= 2; ++k)
        at[k + 2] = wrap(x + k * dx, P) * P2 + wrap(y + k * dy, P) * P +
                    wrap(z + k * dz, P);
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        const float* q = us + f * P3;
        const float um2 = q[at[0]], um1 = q[at[1]], u0 = q[at[2]],
                    up1 = q[at[3]], up2 = q[at[4]];
        lo[f * P3 + c] = ppm_side5(um2, um1, u0, up1, up2, 0);
        hi[f * P3 + c] = ppm_side5(um2, um1, u0, up1, up2, 1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
flux_kernel(const float* __restrict__ recon, float h, float gamma, float gm1,
            float* __restrict__ out, int S) {
  extern __shared__ float face[];
  const int P = S + 2 * kGhost, P3 = P * P * P;
  const size_t slot = blockIdx.x;
  const float* rs = recon + slot * (size_t)kPairs * 2 * kFields * P3;
  float* dst = out + slot * kFields * S * S * S;
  rhs_passes(StagedStates{rs, P}, face, dst, P, S, h, gamma, gm1);
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: upload FACE_QUAD (with
// each entry's pair indices) and DIR_PAIRS into constant memory, and allow
// both kernels the device's opt-in shared memory.  `weights` is 3 x 9
// floats; `table` 3 x 9 x 8 ints as hydro_rhs_init takes it; `pairs`
// 3 x 9 x 2 ints (pair_l, pair_r); `dirs` 13 x 3 ints.  Returns a
// cudaError_t.
int hydro_split_init(const float* weights, const int* table, const int* pairs,
                     const int* dirs) {
  cudaError_t err = upload_quad_table(weights, table, pairs, dirs);
  if (err != cudaSuccess) return (int)err;
  err = allow_optin_smem(reconstruct_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)allow_optin_smem(flux_kernel);
}

// Launch Reconstruct on `stream`; `smem` is 4 * 5 * P^3 bytes.  Returns the
// cudaError_t of the launch (0 on success).
int hydro_reconstruct_launch(const float* u, float* recon, int n, int P,
                             size_t smem, void* stream) {
  if (n <= 0) return 0;
  reconstruct_kernel<<<n, kReconThreads, smem, (cudaStream_t)stream>>>(
      u, recon, P);
  return (int)cudaGetLastError();
}

// Launch Flux on `stream`; `smem` is one axis' face fluxes,
// 4 * 5 * (S+1)*S*S bytes.  `gm1` is gamma - 1, rounded once from double.
// Returns the cudaError_t of the launch (0 on success).
int hydro_flux_launch(const float* recon, float* out, int n, int S, float h,
                      float gamma, float gm1, size_t smem, void* stream) {
  if (n <= 0) return 0;
  flux_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(recon, h, gamma,
                                                           gm1, out, S);
  return (int)cudaGetLastError();
}

const char* hydro_split_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
