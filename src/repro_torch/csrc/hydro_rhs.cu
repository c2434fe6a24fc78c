// Fused hydro RHS for Hopper (sm_90a): CW84 PPM reconstruction + KNP
// central-upwind flux at 9 Simpson points per face + flux divergence, over a
// bucket of aggregated padded sub-grids, one thread-block cluster per slot.
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
//  * A cluster of 3 CTAs per slot, kCtaThreads = 576 threads each (one
//    face per thread at S=8).  CTA rank a evaluates all of axis a's face
//    fluxes into its own shared memory.  A slot that one block evaluated
//    axis after axis now spreads over 3 SMs: a 32-slot bucket launches 96
//    CTAs in place of 32, so the buckets the aggregation ladder drains at
//    cap 32 no longer leave 100 of the 132 SMs idle.  The launch shape
//    was chosen by measurement on the H100 (PERF.md, PR 15): a 32-slot
//    launch took 0.032 ms against 0.034 for 6 CTAs of 288 (each axis'
//    faces split in two), 0.044 for 3 x 288 and 0.053 for 3 x 192 (0.149
//    for the one block per slot it replaces).
//  * The padded slot (5 P^3 floats, 54,880 B at S=8, contiguous) comes in
//    by one bulk copy per cluster, multicast to every CTA of the cluster
//    and counted on one mbarrier per CTA: HBM is read once per slot, and no
//    thread spends instructions on the copy.
//  * Only the faces the divergence consumes are evaluated, (S+1)*S*S per
//    axis, with face_flux from hydro_common.cuh unchanged (the Pallas kernel
//    evaluates every quadrature point at all P^3 cells, 4.8x the work at
//    S=8).  Both PPM sides are still recomputed at every face point (~2.1x
//    the function's operations).
//  * After cluster.sync() the CTAs split the slot's cells; each reads the
//    three axes' face fluxes through distributed shared memory and writes
//    out = ((-d0) - d1) - d2, d_a = (F_hi - F_lo) / h: the order of
//    hydro_common.cuh's div_pass, so the result equals the lane kernel's
//    and the split Flux kernel's bit for bit.  A last
//    cluster.sync() keeps every CTA's shared memory alive until the others
//    have read it.
//  * No reduction crosses slots, so a slot's result does not depend on the
//    bucket it was launched in: aggregated launches stay bit-identical to
//    one whole-wave launch.
//  * Arithmetic follows the reference's expression order; built without
//    --use_fast_math, so sqrt and division are IEEE-rounded.  FACE_QUAD
//    lives in constant memory, uploaded once per device by hydro_rhs_init,
//    which also raises the kernel's shared-memory limit.

#include <cooperative_groups.h>
#include <stdint.h>

#include "hydro_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 3;        // CTAs per slot: one per axis
constexpr int kCtaThreads = 576;   // one face per thread at S=8

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into the same shared-memory offset of every CTA in `mask`, each
// CTA's copy counted on its barrier at the offset of `bar`.
__device__ __forceinline__ void bulk_copy_multicast(void* dst,
                                                    const void* src,
                                                    unsigned bytes,
                                                    uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// face_flux at every face of the AXIS face array (the layout of
// hydro_common.cuh's face_pass), stored field-major with stride `nface`.
template <int AXIS>
__device__ void axis_faces(const PpmStates& states, float* __restrict__ face,
                           int S, float gamma, float gm1) {
  const int P = states.P, P2 = P * P;
  const int NY = face_extent<AXIS>(S, 1), NZ = face_extent<AXIS>(S, 2);
  const int nface = face_extent<AXIS>(S, 0) * NY * NZ;
  const int e = AXIS == 0 ? P2 : (AXIS == 1 ? P : 1);
  for (int fi = threadIdx.x; fi < nface; fi += blockDim.x) {
    const int z = fi % NZ, y = (fi / NZ) % NY, x = fi / (NZ * NY);
    // padded coordinates: the AXIS face index a sits at cell G-1+a
    const int c = (kGhost + x - (AXIS == 0)) * P2 +
                  (kGhost + y - (AXIS == 1)) * P + (kGhost + z - (AXIS == 2));
    float acc[kFields];
    face_flux<AXIS>(states, c, e, gamma, gm1, acc);
#pragma unroll
    for (int f = 0; f < kFields; ++f) face[f * nface + fi] = acc[f];
  }
}

// The cluster's face fluxes of one slot: axis a's faces held field-major
// (stride `nface`) by CTA a at the shared-memory offset of `face`.
struct ClusterFaces {
  cg::cluster_group cluster;
  float* face;
  int nface;

  __device__ __forceinline__ float at(int axis, int f, int fi) const {
    return *cluster.map_shared_rank(face + f * nface + fi, axis);
  }
};

// -(F_hi - F_lo) / h of one axis at cell (x, y, z), into `acc` (assigned
// on axis 0): div_pass's arithmetic and order.
template <int AXIS>
__device__ __forceinline__ void axis_divergence(const ClusterFaces& faces,
                                                int x, int y, int z, int S,
                                                float h,
                                                float (&acc)[kFields]) {
  const int NY = face_extent<AXIS>(S, 1), NZ = face_extent<AXIS>(S, 2);
  const int step = AXIS == 0 ? NY * NZ : (AXIS == 1 ? NZ : 1);
  const int lo = (x * NY + y) * NZ + z;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    const float d = (faces.at(AXIS, f, lo + step) - faces.at(AXIS, f, lo)) / h;
    acc[f] = AXIS == 0 ? -d : acc[f] - d;
  }
}

// Two CTAs per SM (at most 56 registers a thread): left to itself ptxas
// takes 76, which leaves one CTA per SM and slows a 512-slot launch by 40%.
__global__ void __launch_bounds__(kCtaThreads, 2)
hydro_rhs_cluster_kernel(const float* __restrict__ u,
                         const float* __restrict__ h_slots, float h,
                         float gamma, float gm1, float* __restrict__ out,
                         int S) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int axis = (int)cluster.block_rank();
  const int P = S + 2 * kGhost, P3 = P * P * P, S3 = S * S * S;
  const int nface = (S + 1) * S * S;
  const size_t slot = blockIdx.x / kCluster;
  const unsigned slot_bytes = (unsigned)(kFields * P3 * sizeof(float));
  float* us = smem;
  float* face = smem + kFields * P3;

  // every CTA arms its barrier before any copy can land in it
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_expect_tx(&bar, slot_bytes);
  }
  cluster.sync();
  if (axis == 0 && threadIdx.x == 0)
    bulk_copy_multicast(us, u + slot * kFields * P3, slot_bytes, &bar,
                        (uint16_t)((1u << kCluster) - 1));
  mbar_wait(&bar, 0);

  const PpmStates states{us, P};
  if (axis == 0)
    axis_faces<0>(states, face, S, gamma, gm1);
  else if (axis == 1)
    axis_faces<1>(states, face, S, gamma, gm1);
  else
    axis_faces<2>(states, face, S, gamma, gm1);
  cluster.sync();

  const ClusterFaces faces{cluster, face, nface};
  const float hh = h_slots != nullptr ? h_slots[slot] : h;
  float* dst = out + slot * kFields * S3;
  const int cells = (S3 + kCluster - 1) / kCluster;
  const int c1 = min(S3, (axis + 1) * cells);
  for (int ci = axis * cells + threadIdx.x; ci < c1; ci += blockDim.x) {
    const int z = ci % S, y = (ci / S) % S, x = ci / (S * S);
    float acc[kFields];
    axis_divergence<0>(faces, x, y, z, S, hh, acc);
    axis_divergence<1>(faces, x, y, z, S, hh, acc);
    axis_divergence<2>(faces, x, y, z, S, hh, acc);
#pragma unroll
    for (int f = 0; f < kFields; ++f) dst[f * S3 + ci] = acc[f];
  }
  cluster.sync();  // no CTA leaves while another reads its faces
}

// A launch of n clusters of kCluster CTAs of kCtaThreads threads, `smem`
// bytes of dynamic shared memory each, on the default stream; `attr`
// holds its cluster-dimension attribute and must outlive it.
cudaLaunchConfig_t cluster_config(unsigned n, size_t smem,
                                  cudaLaunchAttribute& attr) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * kCluster);
  cfg.blockDim = dim3(kCtaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
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
  return (int)allow_optin_smem(hydro_rhs_cluster_kernel);
}

// Launch on `stream`: n clusters of 3 CTAs of 576 threads.  `smem` is the
// dynamic shared memory of one CTA: the padded slot, then one axis' face
// fluxes, 4 * 5 * (P^3 + (S+1)*S*S) bytes (kernels/hydro_rhs.py::
// smem_bytes).  The caller has checked that u is 16-byte aligned and a
// slot's bytes a multiple of 16.  `gm1` is gamma - 1, rounded once from
// double as the plain version rounds it.  Returns the cudaError_t of the
// launch (0 on success).
int hydro_rhs_launch(const float* u, const float* h_slots, float* out, int n,
                     int S, float h, float gamma, float gm1, size_t smem,
                     void* stream) {
  if (n <= 0) return 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config((unsigned)n, smem, attr);
  cfg.stream = (cudaStream_t)stream;
  cudaError_t err = cudaLaunchKernelEx(&cfg, hydro_rhs_cluster_kernel, u,
                                       h_slots, h, gamma, gm1, out, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and clusters on the device for a launch with
// `smem` bytes of dynamic shared memory per CTA.  Returns a cudaError_t.
int hydro_rhs_occupancy(size_t smem, int* ctas_per_sm, int* clusters) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, hydro_rhs_cluster_kernel, kCtaThreads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, smem, attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters,
                                             hydro_rhs_cluster_kernel, &cfg);
}

const char* hydro_rhs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
