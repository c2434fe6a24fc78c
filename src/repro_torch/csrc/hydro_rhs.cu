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
//  * A cluster of kCluster = 3 CTAs per slot, kCtaThreads = 576 threads
//    each (one face per thread at S=8; both in hydro_common.cuh).  CTA rank
//    a evaluates all of axis a's face fluxes into its own shared memory.
//    A 32-slot bucket launches 96 CTAs, so the buckets the aggregation
//    ladder drains at cap 32 do not leave 100 of the 132 SMs idle.  The
//    launch shape was chosen by measurement on the H100 (PERF.md, Findings).
//    56 registers (__launch_bounds__(576, 2)), 2 CTAs per SM.
//  * The padded slot (5 P^3 floats, 54,880 B at S=8, contiguous) comes in
//    by one bulk copy per cluster, multicast to every CTA of the cluster
//    and counted on one mbarrier per CTA: HBM is read once per slot, and no
//    thread spends instructions on the copy.  The bulk copy moves whole
//    16-byte units between 16-byte-aligned addresses, so it takes the
//    slot's aligned middle; the head and tail (under 16 B each: at odd S
//    a slot is 5 P^3 floats, not a multiple of 4, so successive slots
//    start at each float offset of a 16-byte unit in turn, as may every
//    slot of an unaligned tensor) come by plain loads in every CTA before
//    the cluster.sync() that precedes the copy.  The slot sits in shared
//    memory at an offset of 0-3 floats chosen so that its middle is
//    16-byte aligned there too.  An aligned slot of even S has no head or
//    tail.
//  * Only the faces the divergence consumes are evaluated, (S+1)*S*S per
//    axis, with face_flux from hydro_common.cuh unchanged (the Pallas kernel
//    evaluates every quadrature point at all P^3 cells, 4.8x the work at
//    S=8).  Both PPM sides are still recomputed at every face point (~2.1x
//    the function's operations).
//  * After cluster.sync() the CTAs split the slot's cells; each reads the
//    three axes' face fluxes through distributed shared memory and writes
//    out = ((-d0) - d1) - d2, d_a = (F_hi - F_lo) / h (hydro_common.cuh's
//    cluster_divergence), so the result equals the lane kernel's and the
//    split Flux kernel's bit for bit.  A last cluster.sync() keeps every
//    CTA's shared memory alive until the others have read it.
//  * No reduction crosses slots, so a slot's result does not depend on the
//    bucket it was launched in: aggregated launches stay bit-identical to
//    one whole-wave launch.
//  * Arithmetic follows the reference's expression order; built without
//    --use_fast_math, so sqrt and division are IEEE-rounded.  FACE_QUAD
//    lives in constant memory, uploaded once per device by hydro_rhs_init,
//    which also raises the kernel's shared-memory limit.

#include "hydro_common.cuh"

namespace {

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
  const int nslot = kFields * P3;
  const size_t slot = blockIdx.x / kCluster;
  const float* src = u + slot * nslot;
  // floats before the first 16-byte boundary of the slot, and the bytes
  // of whole 16-byte units from there
  const int head = (int)(((16 - ((uintptr_t)src & 15)) & 15) / 4);
  const unsigned bulk = (unsigned)((nslot - head) / 4 * 16);
  float* us = smem + ((4 - head) & 3);   // us + head is 16-byte aligned
  float* face = smem + 4 + nslot;

  // every CTA arms its barrier before any copy can land in it, and brings
  // in the slot's head and tail itself
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_expect_tx(&bar, bulk);
  }
  for (int i = threadIdx.x; i < head; i += kCtaThreads) us[i] = src[i];
  for (int i = head + (int)bulk / 4 + threadIdx.x; i < nslot;
       i += kCtaThreads)
    us[i] = src[i];
  cluster.sync();
  if (axis == 0 && threadIdx.x == 0)
    bulk_copy_multicast(us + head, src + head, bulk, &bar,
                        (uint16_t)((1u << kCluster) - 1));
  mbar_wait(&bar, 0);

  cluster_faces(axis, PpmStates{us, P}, face, S, gamma, gm1);
  cluster.sync();
  const float hh = h_slots != nullptr ? h_slots[slot] : h;
  cluster_divergence(ClusterFaces{cluster, face, S, S, S, 1}, axis, S, hh,
                     out + slot * kFields * S3);
  cluster.sync();  // no CTA leaves while another reads its faces
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
// dynamic shared memory of one CTA: 16 B of alignment slack, the padded
// slot, then one axis' face fluxes, 4 * (4 + 5 * (P^3 + (S+1)*S*S)) bytes
// (kernels/hydro_rhs.py::smem_bytes).  u need only be 4-byte aligned.
// `gm1` is gamma - 1, rounded once from double as the plain version rounds
// it.  Returns the cudaError_t of the launch (0 on success).
int hydro_rhs_launch(const float* u, const float* h_slots, float* out, int n,
                     int S, float h, float gamma, float gm1, size_t smem,
                     void* stream) {
  if (n <= 0) return 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config((unsigned)n * kCluster, 1,
                                          kCtaThreads, smem, attr);
  cfg.stream = (cudaStream_t)stream;
  cudaError_t err = cudaLaunchKernelEx(&cfg, hydro_rhs_cluster_kernel, u,
                                       h_slots, h, gamma, gm1, out, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and clusters on the device for a launch with
// `smem` bytes of dynamic shared memory per CTA.  Returns a cudaError_t.
int hydro_rhs_occupancy(size_t smem, int* ctas_per_sm, int* clusters) {
  return (int)cluster_occupancy(hydro_rhs_cluster_kernel, kCtaThreads, smem,
                                ctas_per_sm, clusters);
}

const char* hydro_rhs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
