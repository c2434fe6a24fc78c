// Device math shared by the hydro kernels (hydro_rhs.cu, hydro_split.cu,
// hydro_rhs_lane.cu): the CW84 PPM surface value, the KNP central-upwind
// flux, the quadrature table in constant memory, the Simpson-integrated
// flux through one face, and the per-axis face and divergence passes of
// one slot.  Each .cu file builds into its own library, so each gets its
// own copy of the constant table and uploads it itself.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kFields = 5;
constexpr int kQuad = 9;
constexpr int kPairs = 13;
constexpr int kGhost = 3;
constexpr int kThreads = 192;   // face/divergence passes: 576 faces per axis at S=8

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

// Face-buffer layout of one axis: (NX, NY, NZ) with S+1 along AXIS and S
// across, z fastest, so neighbouring threads read neighbouring cells.
template <int AXIS>
__device__ __forceinline__ int face_extent(int S, int dim) {
  return S + (dim == AXIS ? 1 : 0);
}

// The two states of quadrature entry q of an AXIS face, reconstructed from
// the padded slot staged in shared memory (the fused kernel).
struct PpmStates {
  const float* __restrict__ us;   // (F, P, P, P)
  int P;

  template <int AXIS>
  __device__ __forceinline__ void load(int q, int c, int e,
                                       float (&qL)[kFields],
                                       float (&qR)[kFields]) const {
    const int P2 = P * P, P3 = P2 * P;
    const int* l = c_tab.dir_l[AXIS][q];
    const int* r = c_tab.dir_r[AXIS][q];
    const int dl = l[0] * P2 + l[1] * P + l[2];
    const int dr = r[0] * P2 + r[1] * P + r[2];
    const int pl = c_tab.plus_l[AXIS][q], pr = c_tab.plus_r[AXIS][q];
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      qL[f] = ppm_side(us + f * P3 + c, dl, pl);
      qR[f] = ppm_side(us + f * P3 + c + e, dr, pr);
    }
  }
};

// The same two states read from a staged reconstruction (the split Flux
// kernel): one slot's (13, 2, F, P, P, P) in device memory.
struct StagedStates {
  const float* __restrict__ recon;
  int P;

  template <int AXIS>
  __device__ __forceinline__ void load(int q, int c, int e,
                                       float (&qL)[kFields],
                                       float (&qR)[kFields]) const {
    const int P3 = P * P * P;
    const float* L =
        recon + (size_t)((c_tab.pair_l[AXIS][q] * 2 + c_tab.plus_l[AXIS][q]) *
                         kFields) * P3 + c;
    const float* R =
        recon + (size_t)((c_tab.pair_r[AXIS][q] * 2 + c_tab.plus_r[AXIS][q]) *
                         kFields) * P3 + c + e;
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      qL[f] = L[(size_t)f * P3];
      qR[f] = R[(size_t)f * P3];
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

// face_flux at every face the interior divergence reads; stored
// field-major into `face`.  `states` supplies each quadrature entry's left
// and right state.
template <int AXIS, class States>
__device__ void face_pass(const States& states, float* __restrict__ face,
                          int P, int S, float gamma, float gm1) {
  const int P2 = P * P;
  const int NY = face_extent<AXIS>(S, 1), NZ = face_extent<AXIS>(S, 2);
  const int nface = face_extent<AXIS>(S, 0) * NY * NZ;
  const int e = AXIS == 0 ? P2 : (AXIS == 1 ? P : 1);
  for (int fi = threadIdx.x; fi < nface; fi += kThreads) {
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

// out = -d0 - d1 - d2 with d_a = (F_hi - F_lo) / h, accumulated in place by
// the thread that owns each cell (same thread on every axis).
template <int AXIS>
__device__ void div_pass(const float* __restrict__ face,
                         float* __restrict__ out, int S, float h) {
  const int NY = face_extent<AXIS>(S, 1), NZ = face_extent<AXIS>(S, 2);
  const int nface = face_extent<AXIS>(S, 0) * NY * NZ;
  const int S3 = S * S * S;
  const int step = AXIS == 0 ? NY * NZ : (AXIS == 1 ? NZ : 1);
  for (int ci = threadIdx.x; ci < S3; ci += kThreads) {
    const int z = ci % S, y = (ci / S) % S, x = ci / (S * S);
    const int lo = (x * NY + y) * NZ + z;
#pragma unroll
    for (int f = 0; f < kFields; ++f) {
      const float d = (face[f * nface + lo + step] - face[f * nface + lo]) / h;
      float* o = out + f * S3 + ci;
      *o = AXIS == 0 ? -d : *o - d;
    }
  }
}

// The three axes' face and divergence passes of one slot, in the
// reference's order (axis 0, 1, 2); `face` holds one axis' face fluxes.
template <class States>
__device__ void rhs_passes(const States& states, float* __restrict__ face,
                           float* __restrict__ dst, int P, int S, float h,
                           float gamma, float gm1) {
  face_pass<0>(states, face, P, S, gamma, gm1);
  __syncthreads();
  div_pass<0>(face, dst, S, h);
  __syncthreads();
  face_pass<1>(states, face, P, S, gamma, gm1);
  __syncthreads();
  div_pass<1>(face, dst, S, h);
  __syncthreads();
  face_pass<2>(states, face, P, S, gamma, gm1);
  __syncthreads();
  div_pass<2>(face, dst, S, h);
}

}  // namespace
