// Fused hydro RHS for Hopper (sm_90a) in the lane-major layout: CW84 PPM
// reconstruction + KNP central-upwind flux at 9 Simpson points per face +
// flux divergence, with the aggregated tasks on the minor axis.
//
//   u (5, P, P, P, n) fp32  ->  out (5, S, S, S, n) fp32,  P = S + 2*G, G = 3
//
// Replaces the TPU kernels src/repro/kernels/hydro_rhs.py::_kernel_slot_lane
// (static h) and ::_kernel_slot_lane_h (one width per lane): pass
// h_slots=NULL for the scalar width, or one width per task.  It computes
// the function of hydro_rhs.cu (slot_grid) on the transposed array.
//
// What bounds it on an H100: arithmetic, as hydro_rhs.cu.  A 512-task
// bucket at S=8 needs ~1.37 GFLOP (~20 us at 67 TFLOP/s) against 33 MB
// (~10 us at 3.35 TB/s); 64 tasks at S=16 ~1.22 GFLOP against 19 MB.
//
// What the design does about it:
//  * On the TPU the layout fills the 128 vector lanes with tasks.  Here it
//    puts 32 tasks across a warp: thread x of a block is one task (lane),
//    thread y one output cell, so every stencil value a warp loads is 32
//    neighbouring floats, one coalesced transaction across the tasks.
//  * Nothing of size P^3 is staged in shared memory (there is none), so
//    S=16 runs: the slot_grid kernel needs 300,000 B of shared memory per
//    block there, above the 232,448 B limit.  Reuse comes from L1/L2.
//  * Each thread evaluates the two faces of its cell on each axis
//    (face_flux at c and at c - e), so every interior face is computed
//    twice, once from each side: 6 S^3 face evaluations against the
//    3 (S+1) S^2 the slot_grid kernel evaluates, 1.78x at S=8 and 1.88x at
//    S=16, on top of the ~2.1x of both PPM sides recomputed at every face
//    point.  Sharing faces (pencils along an axis in shared memory) is
//    left to a later redesign.
//  * The divergence is accumulated in registers in the reference's order
//    (axis 0, 1, 2: out = -d0 - d1 - d2) with the same device math as the
//    slot_grid kernel (hydro_common.cuh), so both layouts can agree bit for
//    bit.
//  * No value crosses lanes (no shuffle, no shared reduction), and a lane
//    past n (a ragged bucket) or a cell past S^3 returns before any load
//    or store: a task's result does not depend on its bucket or its lane.
//  * Arithmetic follows the reference's expression order; built without
//    --use_fast_math, so sqrt and division are IEEE-rounded.  FACE_QUAD
//    lives in constant memory, uploaded once per device by
//    hydro_rhs_lane_init.

#include "hydro_common.cuh"

namespace {

constexpr int kLaneWarp = 32;   // tasks across a warp (threadIdx.x)
constexpr int kLaneCells = 8;   // output cells per block (threadIdx.y)

// -(F_hi - F_lo) / h of one axis, added into `acc` (assigned on axis 0).
template <int AXIS>
__device__ __forceinline__ void axis_divergence(const LaneStates& st, int c,
                                                int e, float h, float gamma,
                                                float gm1,
                                                float (&acc)[kFields]) {
  float hi[kFields], lo[kFields];
  face_flux<AXIS>(st, c, e, gamma, gm1, hi);
  face_flux<AXIS>(st, c - e, e, gamma, gm1, lo);
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    const float d = (hi[f] - lo[f]) / h;
    acc[f] = AXIS == 0 ? -d : acc[f] - d;
  }
}

__global__ void __launch_bounds__(kLaneWarp * kLaneCells)
hydro_rhs_lane_kernel(const float* __restrict__ u,
                      const float* __restrict__ h_slots, float h,
                      float gamma, float gm1, float* __restrict__ out, int n,
                      int S) {
  const int lane = blockIdx.y * kLaneWarp + threadIdx.x;
  const int S3 = S * S * S;
  const int ci = blockIdx.x * kLaneCells + threadIdx.y;
  if (lane >= n || ci >= S3) return;
  const int P = S + 2 * kGhost, P2 = P * P;
  const int z = ci % S, y = (ci / S) % S, x = ci / (S * S);
  const int c = (kGhost + x) * P2 + (kGhost + y) * P + (kGhost + z);
  const float hh = h_slots != nullptr ? h_slots[lane] : h;
  const LaneStates st{u + lane, P, n};
  float acc[kFields];
  axis_divergence<0>(st, c, P2, hh, gamma, gm1, acc);
  axis_divergence<1>(st, c, P, hh, gamma, gm1, acc);
  axis_divergence<2>(st, c, 1, hh, gamma, gm1, acc);
#pragma unroll
  for (int f = 0; f < kFields; ++f) out[(f * S3 + ci) * n + lane] = acc[f];
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: upload FACE_QUAD into
// constant memory.  `weights` is 3 x 9 floats; `table` is 3 x 9 x 8 ints,
// each entry (dir_l x, y, z, plus_l, dir_r x, y, z, plus_r).  Returns a
// cudaError_t.
int hydro_rhs_lane_init(const float* weights, const int* table) {
  return (int)upload_quad_table(weights, table, nullptr, nullptr);
}

// Launch on `stream`: a grid of (ceil(S^3 / 8) cell groups, ceil(n / 32)
// lane groups), blocks of 32 x 8 threads.  `gm1` is gamma - 1, rounded once
// from double as the plain version rounds it.  The caller keeps
// 5 * P^3 * n below 2^31 (int offsets).  Returns the cudaError_t of the
// launch (0 on success).
int hydro_rhs_lane_launch(const float* u, const float* h_slots, float* out,
                          int n, int S, float h, float gamma, float gm1,
                          void* stream) {
  if (n <= 0) return 0;
  const dim3 block(kLaneWarp, kLaneCells);
  const dim3 grid((S * S * S + kLaneCells - 1) / kLaneCells,
                  (n + kLaneWarp - 1) / kLaneWarp);
  hydro_rhs_lane_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      u, h_slots, h, gamma, gm1, out, n, S);
  return (int)cudaGetLastError();
}

const char* hydro_rhs_lane_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
