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
//  * Reconstruct: one CTA of kReconThreads = 256 threads per (slot, field,
//    x-slab), the P planes split into kReconSlabs = 7 slabs (2 planes at
//    S=8; a slab is empty, and its CTA returns, where P < 7): a 32-slot
//    bucket launches 1,120 CTAs, 512 slots 17,920.  A CTA stages only its
//    field's slab, widened by 2 planes, rows and columns on every side with
//    each index wrapped mod P (torch.roll's shifts), so every sample is a
//    direct index.  Shared memory: (ceil(P / 7) + 4) x (P + 4)^2 floats,
//    7,776 B at S=8, so P <= 62 (kernels/hydro_split.py::
//    RECON_MAX_PADDED).
//    Registers: 40, no spills (ptxas, sm_90a).  Thread t takes the slab's
//    cells e = t, t + 256, ... and writes both sides of all 13 pairs there:
//    neighbouring lanes read neighbouring staged floats (no bank conflicts)
//    and store neighbouring floats of one plane (128 contiguous bytes per
//    warp store).  Plain 4-byte stores need no more than a float's
//    alignment, so the input and the output may each start at any float
//    address.  Flat indices are split by fdiv, a floor division in fp32,
//    exact for every dividend below 2^21 (the largest is ~57,000 at P = 62).
//    Both sides of a pair come from one set of five samples (ppm_side5, as
//    in the fused kernel), and no value depends on the launch shape, so
//    every element equals the plain version's within rounding and a slot's
//    values do not depend on its bucket.
//  * Flux: one thread-block cluster per slot, as hydro_rhs.cu: kCluster =
//    3 CTAs of kCtaThreads = 576 threads (hydro_common.cuh), CTA a
//    evaluating axis a's (S+1)*S*S faces, one face per thread at S=8, into
//    its own shared memory; after cluster.sync() each CTA writes a third of
//    the slot's cells, reading all three axes' faces through distributed
//    shared memory, so out is written once and never read back.  A
//    32-slot bucket launches 96 CTAs, not 32.
//  * Flux's loads are what it waits on: each quadrature entry reads 10
//    staged values per face (5 fields x left and right state), and an
//    entry's loads cannot start before the previous entry's KNP flux is
//    done if they go straight to registers.  So each thread stages its own
//    face's values by 4-byte cp.async (the staged rows start off 16-byte
//    boundaries: P = 14 floats is not a multiple of 4, so neither TMA's
//    16-byte strides nor 16-byte cp.async fit) into a ring of kStages = 2
//    entries in shared memory, [stage][value][thread], one cp.async group
//    per entry: entry q+1 is in flight while entry q's KNP runs.  A thread
//    reads back only what it staged, so cp.async.wait_group alone orders
//    the ring; no block barrier is needed until the faces are done.
//    face_flux (hydro_common.cuh) is unchanged: QueuedStates::load issues
//    entry q+1 and waits for entry q, and ::prime issues entry 0 before
//    each face.  The ring depth was chosen by measurement on the H100
//    (PERF.md, Findings).
//  * Shared memory per CTA: the ring, 2 x 10 x 576 floats (46,080 B), then
//    one axis' face fluxes (11,520 B at S=8): 57,600 B.
//    __launch_bounds__(576, 2) holds ptxas to 56 registers (24 B of
//    spills), 2 CTAs per SM.
//  * No reduction crosses slots, so a slot's result does not depend on the
//    bucket it was launched in.
//  * Built without --use_fast_math: sqrt and division are IEEE-rounded.

#include "hydro_common.cuh"

namespace {

// Reconstruct's launch shape: a CTA per (slot, field, x-slab)
constexpr int kReconThreads = 256;
constexpr int kReconSlabs = 7;       // x-slabs per slot and field

__device__ __forceinline__ int wrap(int i, int P) {
  return i < 0 ? i + P : (i >= P ? i - P : i);
}

// floor(a / b) for 0 <= a < 2^21 from inv_b = 1.0f / b (IEEE): the fp32
// quotient of (a + 0.5) is within 2^-22 of its value relative to it, and
// that value lies at least 0.5 / b from an integer
__device__ __forceinline__ int fdiv(int a, float inv_b) {
  return __float2int_rz(__fmaf_rn((float)a, inv_b, 0.5f * inv_b));
}

// First plane of x-slab g of P planes
__device__ __forceinline__ int recon_slab(int g, int P) {
  return (g * P) / kReconSlabs;
}

__global__ void __launch_bounds__(kReconThreads)
reconstruct_kernel(const float* __restrict__ u, float* __restrict__ out,
                   int P) {
  extern __shared__ float stage[];
  const int g = blockIdx.x % kReconSlabs;
  const int f = (blockIdx.x / kReconSlabs) % kFields;
  const size_t slot = blockIdx.x / (kReconSlabs * kFields);
  const int x0 = recon_slab(g, P), x1 = recon_slab(g + 1, P);
  if (x1 == x0) return;
  const int P2 = P * P, P3 = P2 * P, Q = P + 4, Q2 = Q * Q;
  const float invP = 1.0f / (float)P, invQ = 1.0f / (float)Q;
  // field f over planes [x0 - 2, x1 + 2) and rows and columns [-2, P + 2),
  // each index wrapped mod P: every sample below is a direct index
  const float* src = u + (slot * kFields + f) * (size_t)P3;
  for (int i = threadIdx.x; i < (x1 - x0 + 4) * Q2; i += kReconThreads) {
    const int r = fdiv(i, invQ), Z = i - r * Q;
    const int X = fdiv(r, invQ), Y = r - X * Q;
    stage[i] = src[wrap(x0 - 2 + X, P) * P2 + wrap(Y - 2, P) * P +
                   wrap(Z - 2, P)];
  }
  __syncthreads();
  // cell e of the slab (its planes' cells in order, as every output plane
  // holds them) is staged at cp; its five samples along a pair's direction
  // at cp + k * dp, k = -2 .. 2
  float* dst = out + (slot * kPairs * 2 * kFields + f) * (size_t)P3 +
               (size_t)x0 * P2;
  for (int e = threadIdx.x; e < (x1 - x0) * P2; e += kReconThreads) {
    const int r = fdiv(e, invP), z = e - r * P;
    const int x = fdiv(r, invP), y = r - x * P;
    const float* q = stage + (x + 2) * Q2 + (y + 2) * Q + z + 2;
    for (int pair = 0; pair < kPairs; ++pair) {
      const int dp = c_tab.dirs[pair][0] * Q2 + c_tab.dirs[pair][1] * Q +
                     c_tab.dirs[pair][2];
      const float um2 = q[-2 * dp], um1 = q[-dp], u0 = q[0], up1 = q[dp],
                  up2 = q[2 * dp];
      float* lo = dst + (size_t)(pair * 2 * kFields) * P3;
      lo[e] = ppm_side5(um2, um1, u0, up1, up2, 0);
      lo[(size_t)kFields * P3 + e] = ppm_side5(um2, um1, u0, up1, up2, 1);
    }
  }
}

constexpr int kStages = 2;             // quadrature entries in the ring
constexpr int kStaged = 2 * kFields;   // values per entry and face

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The two states of quadrature entry q of an AXIS face, read from one
// slot's staged reconstruction (13, 2, F, P, P, P) in device memory
// through this thread's ring in shared memory: value k of the entry in
// stage s at queue[(s * kStaged + k) * kCtaThreads + threadIdx.x].
struct QueuedStates {
  const float* __restrict__ recon;
  float* queue;
  int P;

  // cp.async entry q's 10 values (none past the last entry) and commit
  // them as one group: every call commits, so groups count entries
  template <int AXIS>
  __device__ __forceinline__ void issue(int q, int c, int e) const {
    if (q < kQuad) {
      const int P3 = P * P * P;
      const float* L =
          recon + (size_t)((c_tab.pair_l[AXIS][q] * 2 + c_tab.plus_l[AXIS][q])
                           * kFields) * P3 + c;
      const float* R =
          recon + (size_t)((c_tab.pair_r[AXIS][q] * 2 + c_tab.plus_r[AXIS][q])
                           * kFields) * P3 + c + e;
      float* dst = queue + (q % kStages) * kStaged * kCtaThreads + threadIdx.x;
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        cp_async4(dst + f * kCtaThreads, L + (size_t)f * P3);
        cp_async4(dst + (kFields + f) * kCtaThreads, R + (size_t)f * P3);
      }
    }
    cp_async_commit();
  }

  template <int AXIS>
  __device__ __forceinline__ void prime(int c, int e) const {
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) issue<AXIS>(q, c, e);
  }

  // issue entry q + kStages - 1 into the stage entry q - 1 left, then wait
  // until at most kStages - 1 groups are in flight: entry q's is done
  template <int AXIS>
  __device__ __forceinline__ void load(int q, int c, int e,
                                       float (&qL)[kFields],
                                       float (&qR)[kFields]) const {
    issue<AXIS>(q + kStages - 1, c, e);
    cp_async_wait<kStages - 1>();
    const float* src =
        queue + (q % kStages) * kStaged * kCtaThreads + threadIdx.x;
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      qL[f] = src[f * kCtaThreads];
      qR[f] = src[(kFields + f) * kCtaThreads];
    }
  }
};

__global__ void __launch_bounds__(kCtaThreads, 2)
flux_cluster_kernel(const float* __restrict__ recon, float h, float gamma,
                    float gm1, float* __restrict__ out, int S) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int axis = (int)cluster.block_rank();
  const int P = S + 2 * kGhost, P3 = P * P * P;
  const size_t slot = blockIdx.x / kCluster;
  float* face = smem + kStages * kStaged * kCtaThreads;
  const QueuedStates states{
      recon + slot * (size_t)kPairs * 2 * kFields * P3, smem, P};
  cluster_faces(axis, states, face, S, gamma, gm1);
  cluster.sync();
  cluster_divergence(ClusterFaces{cluster, face, S, S, S, 1}, axis, S, h,
                     out + slot * kFields * S * S * S);
  cluster.sync();  // no CTA leaves while another reads its faces
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
  return (int)allow_optin_smem(flux_cluster_kernel);
}

// Launch Reconstruct on `stream`: n x 5 x kReconSlabs CTAs of
// kReconThreads threads, each with one field of its slab staged, (ceil(P /
// kReconSlabs) + 4) x (P + 4)^2 floats of shared memory.  Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue where that
// exceeds the device's opt-in shared memory, P > 62 on an H100).
int hydro_reconstruct_launch(const float* u, float* recon, int n, int P,
                             void* stream) {
  if (n <= 0) return 0;
  const size_t smem = sizeof(float) * ((P + kReconSlabs - 1) / kReconSlabs +
                                       4) * (P + 4) * (P + 4);
  reconstruct_kernel<<<(unsigned)n * kFields * kReconSlabs, kReconThreads,
                       smem, (cudaStream_t)stream>>>(u, recon, P);
  return (int)cudaGetLastError();
}

// Launch Flux on `stream`: n clusters of 3 CTAs of 576 threads.  `smem` is
// the dynamic shared memory of one CTA, the staging ring then one axis'
// face fluxes, 4 * (2 * 10 * 576 + 5 * (S+1)*S*S) bytes
// (kernels/hydro_split.py::flux_smem_bytes).  `gm1` is gamma - 1, rounded
// once from double.  Returns the cudaError_t of the launch (0 on success).
int hydro_flux_launch(const float* recon, float* out, int n, int S, float h,
                      float gamma, float gm1, size_t smem, void* stream) {
  if (n <= 0) return 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config((unsigned)n * kCluster, 1,
                                          kCtaThreads, smem, attr);
  cfg.stream = (cudaStream_t)stream;
  cudaError_t err = cudaLaunchKernelEx(&cfg, flux_cluster_kernel, recon, h,
                                       gamma, gm1, out, S);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and clusters on the device for a Flux launch with
// `smem` bytes of dynamic shared memory per CTA.  Returns a cudaError_t.
int hydro_flux_occupancy(size_t smem, int* ctas_per_sm, int* clusters) {
  return (int)cluster_occupancy(flux_cluster_kernel, kCtaThreads, smem,
                                ctas_per_sm, clusters);
}

const char* hydro_split_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
