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
//  * On the TPU the layout fills the 128 vector lanes with tasks.  Here a
//    CTA takes kLanes = 16 tasks, and a warp 16 tasks of each of two faces
//    or cells, so every stencil value a warp loads is two 64-byte segments
//    of neighbouring floats.
//  * A tile of (tx, ty, tz) cells of 16 tasks is one thread-block cluster
//    of kCluster = 3 CTAs (hydro_common.cuh), kLaneThreads = 384 threads
//    each.  CTA a evaluates axis a's faces of the tile once each, with
//    face_flux unchanged, into its shared memory [field][face][lane] (a
//    warp's 32 threads on 32 banks); after cluster.sync() the three CTAs
//    split the tile's (cell, lane) pairs and form the divergence from the
//    three axes' faces through distributed shared memory, in
//    cluster_divergence's order.  Shared memory per CTA: 4 x 5 x (faces of
//    the tile's largest axis grid) x 16 B, 7,680 B for a 2x2x4 tile and
//    25,600 B for 4^3.  56 registers (__launch_bounds__(384, 3), 52 B of
//    spills), 3 CTAs per SM.
//  * Face evaluations: a face between two tiles is evaluated by both,
//    so a task costs S^3 (3 + 1/tx + 1/ty + 1/tz) evaluations against the
//    3 (S+1) S^2 needed (ragged edge tiles aside): 1.26x for 2x2x4 tiles
//    and 1.11x for 4^3 at S=8, 1.18x for 4^3 at S=16.
//  * The tile is a launch argument, from kernels/hydro_rhs.py::lane_plan
//    (S, n, SMs): of 2^3, 2x2x4, 2x4x4 and 4^3, the one with the fewest
//    evaluations whose grid still covers the device's SMs, else 2^3.  On
//    an H100 (132 SMs) a 32-task bucket at S=8 launches 32 tiles x 2 lane
//    groups x 3 = 192 CTAs, a 512-task bucket 8 x 32 x 3 = 768.  The lane
//    group (16 tasks, 64-byte segments) was chosen by measurement on the
//    H100 (PERF.md, Findings).
//  * Nothing of size P^3 is staged (16 tasks of a 14^3 slot are 878 KB),
//    so S=16 runs: stencil values come through L1 and L2.
//  * No value crosses lanes (no shuffle, no shared reduction), and a lane
//    past n (a ragged bucket) is neither evaluated nor stored: which
//    thread, tile or bucket evaluates a face changes nothing in its bits,
//    so a task's result does not depend on its bucket, and it equals the
//    slot_grid kernel's bit for bit (same face_flux, same divergence).
//  * Arithmetic follows the reference's expression order; built without
//    --use_fast_math, so sqrt and division are IEEE-rounded.  FACE_QUAD
//    lives in constant memory, uploaded once per device by
//    hydro_rhs_lane_init.

#include "hydro_common.cuh"

namespace {

constexpr int kLanes = 16;          // tasks per CTA, two faces a warp
constexpr int kLaneThreads = 384;   // threads per CTA

// face_flux at every (face, lane) of the AXIS face grid of the tile whose
// low cell is (x0, y0, z0), into `face` [field][face][lane].
template <int AXIS>
__device__ void tile_faces(const float* __restrict__ u, const ClusterFaces& g,
                           int x0, int y0, int z0, int lane0, int n, int S,
                           float gamma, float gm1) {
  const int P = S + 2 * kGhost, P2 = P * P;
  const int NY = g.ny<AXIS>(), NZ = g.nz<AXIS>(), nface = g.nface<AXIS>();
  const int e = AXIS == 0 ? P2 : (AXIS == 1 ? P : 1);
  for (int it = threadIdx.x; it < nface * kLanes; it += kLaneThreads) {
    const int l = it % kLanes, fi = it / kLanes;
    if (lane0 + l >= n) continue;
    const int z = fi % NZ, y = (fi / NZ) % NY, x = fi / (NZ * NY);
    // padded coordinates: face k along AXIS sits on the low side of cell k
    const int c = (kGhost + x0 + x - (AXIS == 0)) * P2 +
                  (kGhost + y0 + y - (AXIS == 1)) * P +
                  (kGhost + z0 + z - (AXIS == 2));
    float acc[kFields];
    face_flux<AXIS>(LaneStates{u + lane0 + l, P, n}, c, e, gamma, gm1, acc);
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      g.face[(f * nface + fi) * kLanes + l] = acc[f];
  }
}

// Three CTAs per SM (at most 56 registers a thread).
__global__ void __launch_bounds__(kLaneThreads, 3)
hydro_rhs_lane_kernel(const float* __restrict__ u,
                      const float* __restrict__ h_slots, float h,
                      float gamma, float gm1, float* __restrict__ out, int n,
                      int S, int tx, int ty, int tz) {
  extern __shared__ __align__(16) float face[];
  cg::cluster_group cluster = cg::this_cluster();
  const int axis = (int)cluster.block_rank();
  const int nty = (S + ty - 1) / ty, ntz = (S + tz - 1) / tz;
  const int tile = blockIdx.x / kCluster;
  const int x0 = tile / (nty * ntz) * tx, y0 = tile / ntz % nty * ty,
            z0 = tile % ntz * tz;
  const int lane0 = blockIdx.y * kLanes;
  const ClusterFaces g{cluster, face, min(tx, S - x0), min(ty, S - y0),
                       min(tz, S - z0), kLanes};
  if (axis == 0)
    tile_faces<0>(u, g, x0, y0, z0, lane0, n, S, gamma, gm1);
  else if (axis == 1)
    tile_faces<1>(u, g, x0, y0, z0, lane0, n, S, gamma, gm1);
  else
    tile_faces<2>(u, g, x0, y0, z0, lane0, n, S, gamma, gm1);
  cluster.sync();

  // this CTA's third of the tile's (cell, lane) pairs, lanes fastest
  const int S3 = S * S * S;
  const int items = g.bx * g.by * g.bz * kLanes;
  const int share = (items + kCluster - 1) / kCluster;
  const int i1 = min(items, (axis + 1) * share);
  for (int it = axis * share + threadIdx.x; it < i1; it += kLaneThreads) {
    const int l = it % kLanes, ci = it / kLanes, lane = lane0 + l;
    if (lane >= n) continue;
    const int z = ci % g.bz, y = ci / g.bz % g.by, x = ci / (g.bz * g.by);
    const float hh = h_slots != nullptr ? h_slots[lane] : h;
    float acc[kFields];
    axis_divergence<0>(g, x, y, z, l, hh, acc);
    axis_divergence<1>(g, x, y, z, l, hh, acc);
    axis_divergence<2>(g, x, y, z, l, hh, acc);
    const int cell = ((x0 + x) * S + y0 + y) * S + z0 + z;
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      out[(size_t)(f * S3 + cell) * n + lane] = acc[f];
  }
  cluster.sync();  // no CTA leaves while another reads its faces
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: upload FACE_QUAD into
// constant memory and allow the kernel the device's opt-in shared memory.
// `weights` is 3 x 9 floats; `table` is 3 x 9 x 8 ints, each entry
// (dir_l x, y, z, plus_l, dir_r x, y, z, plus_r).  Returns a cudaError_t.
int hydro_rhs_lane_init(const float* weights, const int* table) {
  cudaError_t err = upload_quad_table(weights, table, nullptr, nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)allow_optin_smem(hydro_rhs_lane_kernel);
}

// Launch on `stream`: `tiles` clusters of 3 CTAs (tiles of (tx, ty, tz)
// cells, x slowest) for each of ceil(n / 16) lane groups, 384 threads and
// `smem` bytes of dynamic shared memory per CTA (kernels/hydro_rhs.py::
// lane_plan).  `gm1` is gamma - 1, rounded once from double as the plain
// version rounds it.  The caller keeps 5 * P^3 * n below 2^31 (int
// offsets).  Returns the cudaError_t of the launch (0 on success).
int hydro_rhs_lane_launch(const float* u, const float* h_slots, float* out,
                          int n, int S, float h, float gamma, float gm1,
                          int tx, int ty, int tz, int tiles, size_t smem,
                          void* stream) {
  if (n <= 0) return 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      (unsigned)tiles * kCluster, (unsigned)((n + kLanes - 1) / kLanes),
      kLaneThreads, smem, attr);
  cfg.stream = (cudaStream_t)stream;
  cudaError_t err = cudaLaunchKernelEx(&cfg, hydro_rhs_lane_kernel, u,
                                       h_slots, h, gamma, gm1, out, n, S, tx,
                                       ty, tz);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and clusters on the device for a launch with
// `smem` bytes of dynamic shared memory per CTA.  Returns a cudaError_t.
int hydro_rhs_lane_occupancy(size_t smem, int* ctas_per_sm, int* clusters) {
  return (int)cluster_occupancy(hydro_rhs_lane_kernel, kLaneThreads, smem,
                                ctas_per_sm, clusters);
}

const char* hydro_rhs_lane_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
