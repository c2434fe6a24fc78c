// Device math shared by the hydro kernels (hydro_rhs.cu, hydro_split.cu,
// hydro_rhs_lane.cu): the CW84 PPM surface value, the KNP central-upwind
// flux, the quadrature table in constant memory, the Simpson-integrated
// flux through one face, and the thread-block-cluster scheme of the
// slot_grid kernels (an axis' faces per CTA, the divergence through
// distributed shared memory).  Each .cu file builds into its own library,
// so each gets its own copy of the constant table and uploads it itself.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kFields = 5;
constexpr int kQuad = 9;
constexpr int kPairs = 13;
constexpr int kGhost = 3;

// FACE_QUAD of repro_torch.hydro.flux: weight, and each state's pair
// direction (x, y, z), side and pair index, for 3 axes x 9 quadrature
// entries; and DIR_PAIRS, the 13 pairs' directions.
struct QuadTable {
  float w[3][kQuad];
  int dir_l[3][kQuad][3];   // the left state's pair, read at cell i
  int plus_l[3][kQuad];     // 1: surface value toward +d, 0: toward -d
  int dir_r[3][kQuad][3];   // the right state's pair, read at cell i + e_axis
  int plus_r[3][kQuad];
  int pair_l[3][kQuad];     // index into DIR_PAIRS (-1 when not uploaded)
  int pair_r[3][kQuad];
  int dirs[kPairs][3];      // DIR_PAIRS (zero when not uploaded)
};

__constant__ QuadTable c_tab;

// Upload the table.  `weights` is 3 x 9 floats; `table` is 3 x 9 x 8 ints,
// each entry (dir_l x, y, z, plus_l, dir_r x, y, z, plus_r); `pairs` is
// 3 x 9 x 2 ints (pair_l, pair_r) and `dirs` 13 x 3 ints, both optional.
inline cudaError_t upload_quad_table(const float* weights, const int* table,
                                     const int* pairs, const int* dirs) {
  QuadTable tab = {};
  for (int a = 0; a < 3; ++a) {
    for (int q = 0; q < kQuad; ++q) {
      const int k = a * kQuad + q;
      const int* t = table + 8 * k;
      tab.w[a][q] = weights[k];
      for (int j = 0; j < 3; ++j) {
        tab.dir_l[a][q][j] = t[j];
        tab.dir_r[a][q][j] = t[4 + j];
      }
      tab.plus_l[a][q] = t[3];
      tab.plus_r[a][q] = t[7];
      tab.pair_l[a][q] = pairs != nullptr ? pairs[2 * k] : -1;
      tab.pair_r[a][q] = pairs != nullptr ? pairs[2 * k + 1] : -1;
    }
  }
  if (dirs != nullptr)
    for (int p = 0; p < kPairs; ++p)
      for (int j = 0; j < 3; ++j) tab.dirs[p][j] = dirs[3 * p + j];
  return cudaMemcpyToSymbol(c_tab, &tab, sizeof(tab));
}

// Allow `kernel` the device's opt-in shared memory per block as dynamic
// shared memory, less what the kernel declares statically.
template <class Kernel>
inline cudaError_t allow_optin_smem(Kernel kernel) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int device = 0, optin = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - (int)attr.sharedSizeBytes);
}

// NaN-propagating max/min, as jnp.maximum / torch.maximum (fmaxf drops NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a < b || b != b) ? b : a;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a > b || b != b) ? b : a;
}

// CW84 limited-parabola surface value of the cell u along a line of five
// samples u(i-2d) .. u(i+2d), toward +d (plus=1) or -d (plus=0).
__device__ __forceinline__ float ppm_side5(float um2, float um1, float u,
                                           float up1, float up2, int plus) {
  const float c7 = (float)(7.0 / 12.0), c1 = (float)(1.0 / 12.0);
  const float ul = c7 * (um1 + u) - c1 * (um2 + up1);
  const float ur = c7 * (u + up1) - c1 * (um1 + up2);
  const bool extremum = (ur - u) * (u - ul) <= 0.f;
  const float du = ur - ul;
  const float u6 = 6.f * (u - 0.5f * (ul + ur));
  float v;
  if (plus) {
    v = (-(du * du) > du * u6) ? 3.f * u - 2.f * ul : ur;
  } else {
    v = (du * u6 > du * du) ? 3.f * u - 2.f * ur : ul;
  }
  return extremum ? u : v;
}

// The same, for the cell at q along stride d.
__device__ __forceinline__ float ppm_side(const float* __restrict__ q, int d,
                                          int plus) {
  return ppm_side5(q[-2 * d], q[-d], q[0], q[d], q[2 * d], plus);
}

struct Prim {
  float rho, vx, vy, vz, p;
};

__device__ __forceinline__ Prim prim(const float (&q)[kFields], float gm1) {
  Prim s;
  s.rho = max_nan(q[0], (float)1e-10);
  s.vx = q[1] / s.rho;
  s.vy = q[2] / s.rho;
  s.vz = q[3] / s.rho;
  const float ke = 0.5f * s.rho * (s.vx * s.vx + s.vy * s.vy + s.vz * s.vz);
  s.p = max_nan(gm1 * (q[4] - ke), (float)1e-12);
  return s;
}

template <int AXIS>
__device__ __forceinline__ float along(const Prim& s) {
  return AXIS == 0 ? s.vx : (AXIS == 1 ? s.vy : s.vz);
}

template <int AXIS>
__device__ __forceinline__ void phys_flux(const float (&q)[kFields],
                                          const Prim& s, float v,
                                          float (&f)[kFields]) {
  f[0] = s.rho * v;
  f[1] = q[1] * v;
  f[2] = q[2] * v;
  f[3] = q[3] * v;
  f[4] = (q[4] + s.p) * v;
  f[1 + AXIS] = f[1 + AXIS] + s.p;
}

// Kurganov-Noelle-Petrova central-upwind flux through an AXIS face.
template <int AXIS>
__device__ __forceinline__ void knp_flux(const float (&qL)[kFields],
                                         const float (&qR)[kFields],
                                         float gamma, float gm1,
                                         float (&flux)[kFields]) {
  const Prim L = prim(qL, gm1), R = prim(qR, gm1);
  const float vL = along<AXIS>(L), vR = along<AXIS>(R);
  const float cL = sqrtf(gamma * L.p / L.rho);
  const float cR = sqrtf(gamma * R.p / R.rho);
  const float ap = max_nan(max_nan(vL + cL, vR + cR), 0.f);
  const float am = min_nan(min_nan(vL - cL, vR - cR), 0.f);
  float fL[kFields], fR[kFields];
  phys_flux<AXIS>(qL, L, vL, fL);
  phys_flux<AXIS>(qR, R, vR, fR);
  const float span = ap - am;
  if (span > (float)1e-12) {
    const float inv = 1.f / max_nan(span, (float)1e-12);
    const float apam_inv = (ap * am) * inv;
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      flux[f] = (ap * fL[f] - am * fR[f]) * inv + apam_inv * (qR[f] - qL[f]);
  } else {
#pragma unroll
    for (int f = 0; f < kFields; ++f) flux[f] = 0.5f * (fL[f] + fR[f]);
  }
}

// The two states of quadrature entry q of an AXIS face, reconstructed from
// the padded slot, or an x-slab of it, staged in shared memory (the fused
// kernel): field f's planes at us + f * fstride, each P x P.
struct PpmStates {
  const float* __restrict__ us;   // (F, planes, P, P), fields fstride apart
  int P, fstride;

  template <int AXIS>
  __device__ __forceinline__ void prime(int, int) const {}

  template <int AXIS>
  __device__ __forceinline__ void load(int q, int c, int e,
                                       float (&qL)[kFields],
                                       float (&qR)[kFields]) const {
    const int P2 = P * P;
    const int* l = c_tab.dir_l[AXIS][q];
    const int* r = c_tab.dir_r[AXIS][q];
    const int dl = l[0] * P2 + l[1] * P + l[2];
    const int dr = r[0] * P2 + r[1] * P + r[2];
    const int pl = c_tab.plus_l[AXIS][q], pr = c_tab.plus_r[AXIS][q];
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      qL[f] = ppm_side(us + f * fstride + c, dl, pl);
      qR[f] = ppm_side(us + f * fstride + c + e, dr, pr);
    }
  }
};

// The two states of quadrature entry q of an AXIS face read straight from
// lane-major device memory (the lane kernel): (F, P, P, P, n) with the
// thread's lane folded into `u`, so one cell step is n floats apart and
// the 32 lanes of a warp read 32 neighbouring floats.
struct LaneStates {
  const float* __restrict__ u;    // &u_t[0][0][0][0][lane]
  int P, n;

  template <int AXIS>
  __device__ __forceinline__ void load(int q, int c, int e,
                                       float (&qL)[kFields],
                                       float (&qR)[kFields]) const {
    const int P2 = P * P, P3 = P2 * P;
    const int* l = c_tab.dir_l[AXIS][q];
    const int* r = c_tab.dir_r[AXIS][q];
    const int dl = (l[0] * P2 + l[1] * P + l[2]) * n;
    const int dr = (r[0] * P2 + r[1] * P + r[2]) * n;
    const int pl = c_tab.plus_l[AXIS][q], pr = c_tab.plus_r[AXIS][q];
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      qL[f] = ppm_side(u + (f * P3 + c) * n, dl, pl);
      qR[f] = ppm_side(u + (f * P3 + c + e) * n, dr, pr);
    }
  }
};

// Simpson-integrated flux through the +AXIS face of the cell at padded
// index c (its neighbour across the face at c + e): the weighted KNP flux
// of the 9 quadrature entries, accumulated in the reference's order.
template <int AXIS, class States>
__device__ __forceinline__ void face_flux(const States& states, int c, int e,
                                          float gamma, float gm1,
                                          float (&acc)[kFields]) {
#pragma unroll 1
  for (int q = 0; q < kQuad; ++q) {
    float qL[kFields], qR[kFields], flux[kFields];
    states.template load<AXIS>(q, c, e, qL, qR);
    knp_flux<AXIS>(qL, qR, gamma, gm1, flux);
    const float w = c_tab.w[AXIS][q];
#pragma unroll
    for (int f = 0; f < kFields; ++f)
      acc[f] = q == 0 ? w * flux[f] : acc[f] + w * flux[f];
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// One thread-block cluster per slot (hydro_rhs.cu, hydro_split.cu's Flux)
// or per tile of lanes (hydro_rhs_lane.cu): CTA a evaluates axis a's faces
// into its own shared memory, then every CTA forms the divergence of its
// share of the cells through distributed shared memory.
// ---------------------------------------------------------------------------

constexpr int kCluster = 3;        // CTAs per cluster: one per axis
constexpr int kCtaThreads = 576;   // per slot kernel CTA: a face each at S=8

// Face fluxes of a box of (bx, by, bz) cells held by a cluster: CTA a holds
// axis a's faces at the shared-memory offset of `face`, laid out
// [field][face][lane] with `lanes` tasks per face.  Axis a's face grid has
// one more face along a than the box has cells, z fastest, and face index
// k along a is the face on the low side of the box's cell k.
struct ClusterFaces {
  cg::cluster_group cluster;
  float* face;
  int bx, by, bz, lanes;

  template <int AXIS>
  __device__ __forceinline__ int ny() const { return by + (AXIS == 1); }
  template <int AXIS>
  __device__ __forceinline__ int nz() const { return bz + (AXIS == 2); }
  template <int AXIS>
  __device__ __forceinline__ int nface() const {
    return (bx + (AXIS == 0)) * ny<AXIS>() * nz<AXIS>();
  }
  template <int AXIS>
  __device__ __forceinline__ float at(int f, int fi, int lane) const {
    return *cluster.map_shared_rank(
        face + (f * nface<AXIS>() + fi) * lanes + lane, AXIS);
  }
};

// -(F_hi - F_lo) / h of one axis at the box's cell (x, y, z), into `acc`
// (assigned on axis 0): out = ((-d0) - d1) - d2, the reference's order, in
// every kernel that forms a divergence.
template <int AXIS>
__device__ __forceinline__ void axis_divergence(const ClusterFaces& faces,
                                                int x, int y, int z, int lane,
                                                float h,
                                                float (&acc)[kFields]) {
  const int NY = faces.ny<AXIS>(), NZ = faces.nz<AXIS>();
  const int step = AXIS == 0 ? NY * NZ : (AXIS == 1 ? NZ : 1);
  const int lo = (x * NY + y) * NZ + z;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    const float d = (faces.at<AXIS>(f, lo + step, lane) -
                     faces.at<AXIS>(f, lo, lane)) / h;
    acc[f] = AXIS == 0 ? -d : acc[f] - d;
  }
}

// face_flux at the first `nx` x-rows of one slot's AXIS face grid (all
// of them: nx = S + (AXIS == 0)), or of an x-slab's, whose planes the
// states index from the slab's first; one face per thread per step, stored
// field-major into `face`, fields `stride` floats apart (ClusterFaces'
// layout with one lane when stride is the face count).
// `states.prime<AXIS>(c, e)` runs before each face.
template <int AXIS, class States>
__device__ void axis_faces(const States& states, float* __restrict__ face,
                           int nx, int stride, int S, float gamma,
                           float gm1) {
  const int P = states.P, P2 = P * P;
  const int NY = S + (AXIS == 1), NZ = S + (AXIS == 2);
  const int nface = nx * NY * NZ;
  const int e = AXIS == 0 ? P2 : (AXIS == 1 ? P : 1);
  for (int fi = threadIdx.x; fi < nface; fi += kCtaThreads) {
    const int z = fi % NZ, y = (fi / NZ) % NY, x = fi / (NZ * NY);
    // padded coordinates: the AXIS face index a sits at cell G-1+a
    const int c = (kGhost + x - (AXIS == 0)) * P2 +
                  (kGhost + y - (AXIS == 1)) * P + (kGhost + z - (AXIS == 2));
    states.template prime<AXIS>(c, e);
    float acc[kFields];
    face_flux<AXIS>(states, c, e, gamma, gm1, acc);
#pragma unroll
    for (int f = 0; f < kFields; ++f) face[f * stride + fi] = acc[f];
  }
}

// Faces of AXIS's face grid over `nx` x-rows of a slot's cells (one row
// more along x than the slot has cells when AXIS is 0 and nx = S + 1).
template <int AXIS>
__device__ __forceinline__ int face_rows(int nx, int S) {
  return nx * (S + (AXIS == 1)) * (S + (AXIS == 2));
}

// The CTA of rank `axis` evaluates its axis' faces of one slot.
template <class States>
__device__ __forceinline__ void cluster_faces(int axis, const States& states,
                                              float* __restrict__ face, int S,
                                              float gamma, float gm1) {
  if (axis == 0)
    axis_faces<0>(states, face, S + 1, face_rows<0>(S + 1, S), S, gamma,
                  gm1);
  else if (axis == 1)
    axis_faces<1>(states, face, S, face_rows<1>(S, S), S, gamma, gm1);
  else
    axis_faces<2>(states, face, S, face_rows<2>(S, S), S, gamma, gm1);
}

// After the cluster.sync() that follows the face passes: CTA `axis` writes
// its third of the slot's cells of dst (F, S, S, S), reading the three
// axes' faces through distributed shared memory.
__device__ __forceinline__ void cluster_divergence(const ClusterFaces& faces,
                                                   int axis, int S, float h,
                                                   float* __restrict__ dst) {
  const int S3 = S * S * S;
  const int cells = (S3 + kCluster - 1) / kCluster;
  const int c1 = min(S3, (axis + 1) * cells);
  for (int ci = axis * cells + threadIdx.x; ci < c1; ci += kCtaThreads) {
    const int z = ci % S, y = (ci / S) % S, x = ci / (S * S);
    float acc[kFields];
    axis_divergence<0>(faces, x, y, z, 0, h, acc);
    axis_divergence<1>(faces, x, y, z, 0, h, acc);
    axis_divergence<2>(faces, x, y, z, 0, h, acc);
#pragma unroll
    for (int f = 0; f < kFields; ++f) dst[f * S3 + ci] = acc[f];
  }
}

// A launch of `ctas` CTAs in clusters of `cluster` along x, `threads`
// each, `smem` bytes of dynamic shared memory, `grid_y` rows; `attr` holds
// the cluster-dimension attribute and must outlive the launch.
inline cudaLaunchConfig_t cluster_config(unsigned ctas, unsigned grid_y,
                                         unsigned threads, size_t smem,
                                         cudaLaunchAttribute& attr,
                                         unsigned cluster = kCluster) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, grid_y);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Resident CTAs per SM and clusters on the device for `kernel` launched
// with `threads` threads and `smem` bytes of dynamic shared memory per CTA,
// in clusters of `cluster` CTAs.
template <class Kernel>
inline cudaError_t cluster_occupancy(Kernel kernel, unsigned threads,
                                     size_t smem, int* ctas_per_sm,
                                     int* clusters,
                                     unsigned cluster = kCluster) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, kernel, (int)threads, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, 1, threads, smem,
                                                attr, cluster);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace
