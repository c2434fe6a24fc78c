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

// Launch Reconstruct on `stream`; `smem` is 4 * 5 * P^3 bytes.  Returns the
// cudaError_t of the launch (0 on success).
int hydro_reconstruct_launch(const float* u, float* recon, int n, int P,
                             size_t smem, void* stream) {
  if (n <= 0) return 0;
  reconstruct_kernel<<<n, kReconThreads, smem, (cudaStream_t)stream>>>(
      u, recon, P);
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
