// Fused hydro RHS for Hopper (sm_90a): CW84 PPM reconstruction + KNP
// central-upwind flux at 9 Simpson points per face + flux divergence, over a
// bucket of aggregated padded sub-grids.
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
//  * It evaluates only the faces the divergence consumes, (S+1)*S*S per
//    axis, by direct indexing.  The Pallas kernel rolls whole P^3 arrays and
//    so evaluates every quadrature point at all P^3 cells (4.8x the work at
//    S=8).  Every sample index stays inside [0, P-1] for G=3, so no
//    wrap-around is ever read.
//  * It recomputes both PPM sides at every face point instead of staging
//    the 13 pairs' reconstruction (~2.1x the function's operations, no
//    intermediate storage).  Sharing them is the next step toward the bound.
//  * One block per slot: the padded slot is staged once into dynamic shared
//    memory (each input byte is read from HBM once) and the face fluxes of
//    one axis stay in shared memory (~66 KB per block at S=8, 3 blocks per
//    SM).  The divergence of each axis is added into the output by the
//    thread that owns the cell, in the reference's order (axis 0, 1, 2).
//  * No reduction crosses slots, so a slot's result does not depend on the
//    bucket it was launched in: aggregated launches stay bit-identical to
//    one whole-wave launch.
//  * Arithmetic follows the reference's expression order; built without
//    --use_fast_math, so sqrt and division are IEEE-rounded.
//  * FACE_QUAD lives in constant memory, uploaded once per device by
//    hydro_rhs_init, which also raises the kernel's shared-memory limit.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kFields = 5;
constexpr int kQuad = 9;
constexpr int kGhost = 3;
constexpr int kThreads = 192;   // 576 faces per axis at S=8: 3 rounds

// FACE_QUAD of repro_torch.hydro.flux: weight, and each state's pair
// direction (x, y, z) and side, for 3 axes x 9 quadrature entries
struct QuadTable {
  float w[3][kQuad];
  int dir_l[3][kQuad][3];   // the left state's pair, read at cell i
  int plus_l[3][kQuad];     // 1: surface value toward +d, 0: toward -d
  int dir_r[3][kQuad][3];   // the right state's pair, read at cell i + e_axis
  int plus_r[3][kQuad];
};

__constant__ QuadTable c_tab;

// NaN-propagating max/min, as jnp.maximum / torch.maximum (fmaxf drops NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a < b || b != b) ? b : a;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a > b || b != b) ? b : a;
}

// CW84 limited-parabola surface value of the cell at q along stride d,
// toward +d (plus=1) or -d (plus=0).
__device__ __forceinline__ float ppm_side(const float* __restrict__ q, int d,
                                          int plus) {
  const float um2 = q[-2 * d], um1 = q[-d], u = q[0], up1 = q[d],
              up2 = q[2 * d];
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

// Simpson-integrated flux through the +AXIS face of every cell whose face
// the interior divergence reads; stored field-major into `face`.
template <int AXIS>
__device__ void face_pass(const float* __restrict__ us,
                          float* __restrict__ face, int P, int S,
                          float gamma, float gm1) {
  const int P2 = P * P, P3 = P2 * P;
  const int NY = face_extent<AXIS>(S, 1), NZ = face_extent<AXIS>(S, 2);
  const int nface = face_extent<AXIS>(S, 0) * NY * NZ;
  const int e = AXIS == 0 ? P2 : (AXIS == 1 ? P : 1);
  for (int fi = threadIdx.x; fi < nface; fi += kThreads) {
    const int z = fi % NZ, y = (fi / NZ) % NY, x = fi / (NZ * NY);
    // padded coordinates: the AXIS face index a sits at cell G-1+a
    const int c = (kGhost + x - (AXIS == 0)) * P2 +
                  (kGhost + y - (AXIS == 1)) * P + (kGhost + z - (AXIS == 2));
    float acc[kFields];
#pragma unroll 1
    for (int q = 0; q < kQuad; ++q) {
      const int* l = c_tab.dir_l[AXIS][q];
      const int* r = c_tab.dir_r[AXIS][q];
      const int dl = l[0] * P2 + l[1] * P + l[2];
      const int dr = r[0] * P2 + r[1] * P + r[2];
      const int pl = c_tab.plus_l[AXIS][q], pr = c_tab.plus_r[AXIS][q];
      float qL[kFields], qR[kFields], flux[kFields];
#pragma unroll
      for (int f = 0; f < kFields; ++f) {
        qL[f] = ppm_side(us + f * P3 + c, dl, pl);
        qR[f] = ppm_side(us + f * P3 + c + e, dr, pr);
      }
      knp_flux<AXIS>(qL, qR, gamma, gm1, flux);
      const float w = c_tab.w[AXIS][q];
#pragma unroll
      for (int f = 0; f < kFields; ++f)
        acc[f] = q == 0 ? w * flux[f] : acc[f] + w * flux[f];
    }
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

__global__ void __launch_bounds__(kThreads, 3)
hydro_rhs_kernel(const float* __restrict__ u,
                 const float* __restrict__ h_slots, float h, float gamma,
                 float gm1, float* __restrict__ out, int S) {
  extern __shared__ float smem[];
  const int P = S + 2 * kGhost, P3 = P * P * P;
  float* us = smem;
  float* face = smem + kFields * P3;
  const size_t slot = blockIdx.x;
  const float* src = u + slot * kFields * P3;
  for (int i = threadIdx.x; i < kFields * P3; i += kThreads) us[i] = src[i];
  const float hh = h_slots != nullptr ? h_slots[slot] : h;
  float* dst = out + slot * kFields * S * S * S;
  __syncthreads();
  face_pass<0>(us, face, P, S, gamma, gm1);
  __syncthreads();
  div_pass<0>(face, dst, S, hh);
  __syncthreads();
  face_pass<1>(us, face, P, S, gamma, gm1);
  __syncthreads();
  div_pass<1>(face, dst, S, hh);
  __syncthreads();
  face_pass<2>(us, face, P, S, gamma, gm1);
  __syncthreads();
  div_pass<2>(face, dst, S, hh);
}

}  // namespace

extern "C" {

// Once per device, before the first launch there: upload FACE_QUAD into
// constant memory and allow the kernel the device's opt-in shared memory.
// `weights` is 3 x 9 floats; `table` is 3 x 9 x 8 ints, each entry
// (dir_l x, y, z, plus_l, dir_r x, y, z, plus_r).  Returns a cudaError_t.
int hydro_rhs_init(const float* weights, const int* table) {
  QuadTable tab;
  for (int a = 0; a < 3; ++a) {
    for (int q = 0; q < kQuad; ++q) {
      const int* t = table + 8 * (a * kQuad + q);
      tab.w[a][q] = weights[a * kQuad + q];
      for (int k = 0; k < 3; ++k) {
        tab.dir_l[a][q][k] = t[k];
        tab.dir_r[a][q][k] = t[4 + k];
      }
      tab.plus_l[a][q] = t[3];
      tab.plus_r[a][q] = t[7];
    }
  }
  cudaError_t err = cudaMemcpyToSymbol(c_tab, &tab, sizeof(tab));
  if (err != cudaSuccess) return (int)err;
  int device = 0, optin = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      hydro_rhs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
}

// Launch on `stream`.  `smem` is the dynamic shared memory of one block:
// the padded slot, then one axis' face fluxes, 4 * 5 * (P^3 + (S+1)*S*S)
// bytes (kernels/hydro_rhs.py::smem_bytes).  `gm1` is gamma - 1, rounded
// once from double as the plain version rounds it.  Returns the cudaError_t
// of the launch (0 on success).
int hydro_rhs_launch(const float* u, const float* h_slots, float* out, int n,
                     int S, float h, float gamma, float gm1, size_t smem,
                     void* stream) {
  if (n <= 0) return 0;
  hydro_rhs_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      u, h_slots, h, gamma, gm1, out, S);
  return (int)cudaGetLastError();
}

const char* hydro_rhs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
