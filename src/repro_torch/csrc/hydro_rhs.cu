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
//  * A cluster of kCluster = 3 CTAs per x-slab of the slot, kCtaThreads =
//    576 threads each (one face per thread at S=8; both in
//    hydro_common.cuh).  CTA (slab j, axis a), cluster rank 3 j + a,
//    evaluates axis a's face fluxes of slab j into its own shared memory.
//    The slot is one slab (`slabs` = 1) wherever it fits one CTA's shared
//    memory, S <= 14: a 32-slot bucket then launches 96 CTAs, so the
//    buckets the aggregation ladder drains at cap 32 do not leave 100 of the
//    132 SMs idle.  The launch shape was chosen by measurement on the H100
//    (PERF.md, Findings).  56 registers (__launch_bounds__(576, 2)), 2 CTAs
//    per SM at S=8.
//  * At S = 15..17 the padded slot and one axis' faces outgrow a CTA
//    (300,016 B at S=16 against 232,448), so the slot splits into 2 x-slabs,
//    a cluster of 6 CTAs (the portable limit is 8).  Each CTA stages only
//    its slab widened by the 3-cell stencil on both sides, (w + 6) planes
//    of P x P per field for w cells, and slab j's lowest x face is
//    evaluated once, by slab j alone: slab j-1's last cell reads it through
//    distributed shared memory.  181,616 B per CTA at S=16 (w = 8): one CTA
//    per SM, so a 64-slot bucket is 384 CTAs on 132 SMs.
//    kernels/hydro_rhs.py::slab_plan picks the fewest slabs that fit.
//  * The staged block comes in by bulk copies, each multicast to the 3 CTAs
//    of the slab and counted on one mbarrier per CTA: HBM is read once per
//    slab (the stencil's 6 planes twice), and no thread spends instructions
//    on the copy.  One slab is the whole slot, contiguous, and comes as one
//    copy; a slab of a split slot is contiguous per field only, so it comes
//    as 5 copies, one per field.  A bulk copy moves whole 16-byte units
//    between 16-byte-aligned addresses, so each copy takes its run's
//    aligned middle; the head and tail (under 16 B each: at odd S a slot is
//    5 P^3 floats, not a multiple of 4, so successive slots start at each
//    float offset of a 16-byte unit in turn, as may every slot of an
//    unaligned tensor) come by plain loads in every CTA before the
//    cluster.sync() that precedes the copies.  The block sits in shared
//    memory at an offset of 0-3 floats, and its fields `fstride` floats
//    apart with fstride = P^3 (mod 4), so every run's middle is 16-byte
//    aligned there too.  An aligned slot of even S has no head or tail.
//  * Only the faces the divergence consumes are evaluated, (S+1)*S*S per
//    axis, with face_flux from hydro_common.cuh unchanged (the Pallas kernel
//    evaluates every quadrature point at all P^3 cells, 4.8x the work at
//    S=8).  Both PPM sides are still recomputed at every face point (~2.1x
//    the function's operations).
//  * After cluster.sync() the 3 CTAs of a slab split its cells; each reads
//    the three axes' face fluxes through distributed shared memory and
//    writes out = ((-d0) - d1) - d2, d_a = (F_hi - F_lo) / h, the order of
//    hydro_common.cuh's cluster_divergence, so the result equals the lane
//    kernel's and the split Flux kernel's bit for bit, and does not depend
//    on the slab count.  A last cluster.sync() keeps every CTA's shared
//    memory alive until the others have read it.
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

// Floats before the first 16-byte boundary at p, and the bytes of whole
// 16-byte units of an n-float run from there
__device__ __forceinline__ int head_floats(const float* p) {
  return (int)(((16 - ((uintptr_t)p & 15)) & 15) / 4);
}
__device__ __forceinline__ unsigned bulk_bytes(const float* p, int n) {
  return (unsigned)((n - head_floats(p)) / 4 * 16);
}

// Slab j's CTAs, after the cluster.sync() that follows the face passes:
// CTA `axis` writes its third of the slab's w x S x S cells of dst (the
// slab's first cell of the slot's (F, S, S, S) output), reading the faces
// through distributed shared memory.  Every axis-a CTA keeps its fields
// stride[a] floats apart; the slab's axis-0 CTA holds its x faces 0 .. w-1
// (and w, in the last slab), so the high face of a slab's last cell is the
// next slab's face 0.
__device__ __forceinline__ void slab_divergence(
    const cg::cluster_group& cluster, float* face, int slab, int slabs,
    int axis, int w, const int (&stride)[3], int S, float h,
    float* __restrict__ dst) {
  const int S2 = S * S, S3 = S2 * S, cells = w * S2;
  const int share = (cells + kCluster - 1) / kCluster;
  const int c1 = min(cells, (axis + 1) * share);
  const int r0 = kCluster * slab;
  const int nx0 = w + (slab == slabs - 1);
  const float* f0 = cluster.map_shared_rank(face, r0);
  const float* f1 = cluster.map_shared_rank(face, r0 + 1);
  const float* f2 = cluster.map_shared_rank(face, r0 + 2);
  const float* next =
      cluster.map_shared_rank(face, slab + 1 < slabs ? r0 + kCluster : r0);
  for (int ci = axis * share + threadIdx.x; ci < c1; ci += kCtaThreads) {
    const int z = ci % S, y = (ci / S) % S, x = ci / S2;
    const float* lo0 = f0 + x * S2 + y * S + z;
    const float* hi0 = x + 1 < nx0 ? lo0 + S2 : next + y * S + z;
    const float* lo1 = f1 + (x * (S + 1) + y) * S + z;
    const float* lo2 = f2 + (x * S + y) * (S + 1) + z;
    float acc[kFields];
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      acc[f] = -((hi0[f * stride[0]] - lo0[f * stride[0]]) / h);
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      acc[f] = acc[f] - (lo1[f * stride[1] + S] - lo1[f * stride[1]]) / h;
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      acc[f] = acc[f] - (lo2[f * stride[2] + 1] - lo2[f * stride[2]]) / h;
#pragma unroll
    for (int f = 0; f < kFields; ++f) dst[f * S3 + ci] = acc[f];
  }
}

// Two CTAs per SM at S=8 (at most 56 registers a thread): left to itself
// ptxas takes 76, which leaves one CTA per SM and slows a 512-slot launch
// by 40%.
__global__ void __launch_bounds__(kCtaThreads, 2)
hydro_rhs_cluster_kernel(const float* __restrict__ u,
                         const float* __restrict__ h_slots, float h,
                         float gamma, float gm1, float* __restrict__ out,
                         int S, int slabs) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int slab = rank / kCluster, axis = rank % kCluster;
  const int P = S + 2 * kGhost, P2 = P * P, P3 = P2 * P;
  const size_t slot = blockIdx.x / (kCluster * slabs);
  // this slab's cells [x0, x0 + w) along x; every CTA lays out shared
  // memory for the widest slab, wmax cells, whose fields span `span` floats
  const int x0 = slab * S / slabs, w = (slab + 1) * S / slabs - x0;
  const int wmax = (S + slabs - 1) / slabs;
  const int span = (wmax + 2 * kGhost) * P2;
  const int fstride = span + ((P3 - span) & 3);
  // the slot's padded planes [x0, x0 + w + 6) of each field: one run when
  // they are the whole slot, else one run per field
  const float* src = u + slot * kFields * P3 + (size_t)x0 * P2;
  const int runs = slabs == 1 ? 1 : kFields;
  const int run = slabs == 1 ? kFields * P3 : (w + 2 * kGhost) * P2;
  float* us = smem + ((4 - head_floats(src)) & 3);  // us + head: aligned
  float* face = smem + 4 + (kFields - 1) * fstride + span;

  // every CTA arms its barrier before any copy can land in it, and brings
  // in each run's head and tail itself
  if (threadIdx.x == 0) {
    unsigned tx = 0;
    for (int r = 0; r < runs; ++r) tx += bulk_bytes(src + (size_t)r * P3, run);
    mbar_init(&bar, 1);
    mbar_expect_tx(&bar, tx);
  }
  for (int r = 0; r < runs; ++r) {
    const float* rs = src + (size_t)r * P3;
    float* rd = us + r * fstride;
    const int head = head_floats(rs);
    for (int i = threadIdx.x; i < head; i += kCtaThreads) rd[i] = rs[i];
    for (int i = head + (int)bulk_bytes(rs, run) / 4 + threadIdx.x; i < run;
         i += kCtaThreads)
      rd[i] = rs[i];
  }
  cluster.sync();
  if (axis == 0 && threadIdx.x == 0) {
    const uint16_t mask =
        (uint16_t)(((1u << kCluster) - 1) << (kCluster * slab));
    for (int r = 0; r < runs; ++r) {
      const float* rs = src + (size_t)r * P3;
      const int head = head_floats(rs);
      bulk_copy_multicast(us + r * fstride + head, rs + head,
                          bulk_bytes(rs, run), &bar, mask);
    }
  }
  mbar_wait(&bar, 0);

  // face strides: each axis' face grid over the widest slab
  const int stride[3] = {(wmax + 1) * S * S, wmax * (S + 1) * S,
                         wmax * S * (S + 1)};
  const PpmStates states{us, P, fstride};
  if (axis == 0)
    axis_faces<0>(states, face, w + (slab == slabs - 1), stride[0], S, gamma,
                  gm1);
  else if (axis == 1)
    axis_faces<1>(states, face, w, stride[1], S, gamma, gm1);
  else
    axis_faces<2>(states, face, w, stride[2], S, gamma, gm1);
  cluster.sync();
  const float hh = h_slots != nullptr ? h_slots[slot] : h;
  slab_divergence(cluster, face, slab, slabs, axis, w, stride, S, hh,
                  out + slot * kFields * S * S * S + (size_t)x0 * S * S);
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

// Launch on `stream`: n clusters of 3 x `slabs` CTAs of 576 threads.
// `smem` is the dynamic shared memory of one CTA: 16 B of alignment slack,
// the widest slab's 5 fields, then one axis' face fluxes over it
// (kernels/hydro_rhs.py::slab_plan; 4 * (4 + 5 * (P^3 + (S+1)*S*S)) bytes
// for one slab).  u need only be 4-byte aligned.  `gm1` is gamma - 1,
// rounded once from double as the plain version rounds it.  Returns the
// cudaError_t of the launch (0 on success).
int hydro_rhs_launch(const float* u, const float* h_slots, float* out, int n,
                     int S, int slabs, float h, float gamma, float gm1,
                     size_t smem, void* stream) {
  if (n <= 0) return 0;
  const unsigned cluster = (unsigned)(kCluster * slabs);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config((unsigned)n * cluster, 1,
                                          kCtaThreads, smem, attr, cluster);
  cfg.stream = (cudaStream_t)stream;
  cudaError_t err = cudaLaunchKernelEx(&cfg, hydro_rhs_cluster_kernel, u,
                                       h_slots, h, gamma, gm1, out, S, slabs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and clusters on the device for a launch of `slabs`
// slabs per slot with `smem` bytes of dynamic shared memory per CTA.
// Returns a cudaError_t.
int hydro_rhs_occupancy(size_t smem, int slabs, int* ctas_per_sm,
                        int* clusters) {
  return (int)cluster_occupancy(hydro_rhs_cluster_kernel, kCtaThreads, smem,
                                ctas_per_sm, clusters,
                                (unsigned)(kCluster * slabs));
}

const char* hydro_rhs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
