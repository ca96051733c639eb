// Fused D3Q19/D3Q27 stream+collide for Hopper (sm_90a), written by hand.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * lbm_stream_collide       <- repro/kernels/lbm_collide/lbm_collide.py
//                                 lbm_stream_collide_pallas (_kernel ->
//                                 _stream_collide_body)
//   * lbm_stream_collide_halo  <- lbm_stream_collide_halo_pallas (_halo_kernel)
//
// What bounds it: bytes. Per cell the stencil reads Q pdfs and one int32
// cell type and writes Q pdfs, about 4 flops per byte moved, far below the
// H100's ratio of peak flops to HBM bandwidth (about 20 for fp32). So the
// only number that matters is how close the kernel comes to moving each
// byte once at 3.35 TB/s.
//
// Design (a first, simple kernel; tiling is later work):
//   * One thread per cell, a 1-D grid over B*X*Y*Z with Z innermost, so the
//     Q-plane reads and writes of a warp touch consecutive addresses.
//   * The TPU kernel kept a whole 34^3 block (about 3 MB) resident in VMEM
//     for one grid step; a CTA has at most 227 KB of shared memory, so here
//     neighbours are pulled straight from global memory and L1/L2 serve the
//     reuse between the 19/27 overlapping reads.
//   * Source indices wrap inside the block, as jnp.roll does: the ghost ring
//     is stream-collided too, with wrapped values, exactly like the oracle.
//   * rho and u are summed in registers in the fixed q order of the Pallas
//     body; feq is recomputed per direction instead of being stored.
//   * Non-fluid cells copy their input.
//   * The lattice tables live in __constant__ memory. The collision
//     coefficients (om, or om_p/om_m, and the lid vector) arrive as kernel
//     arguments, already rounded to the working type on the host.
//   * 64-bit offsets throughout: a full-cavity level of about 600 blocks of
//     34^3 D3Q19 cells holds about 4.5e8 elements.
//
// The halo variant is two launches on one stream: a fill kernel (one thread
// per (block, pad row)) writes the exchanged ghost values into the ghost
// ring of the *input* buffer, then the stencil above runs. On the TPU one
// grid step owned a whole block and could fill and read in one program; on
// the GPU a block spans many CTAs, and a fill racing a neighbour's read
// would be wrong, so the launch boundary orders them.
//
// C interface: plain functions taking raw pointers and the CUDA stream,
// returning cudaGetLastError() as an int, loaded from Python with ctypes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFluid = 0;
constexpr int kLid = 2;

// D3Q27 velocities; D3Q19 is its first 19 entries. The ordering pairs each
// direction q >= 1 with its opposite: opposite(q) = q + 1 for odd q, q - 1
// for even q (the TRT loop below relies on that pairing).
__constant__ int c_cx[27] = {0, 1, -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1,
                             -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1};
__constant__ int c_cy[27] = {0, 0, 0, 1, -1, 0, 0, 1, -1, -1, 1, 0, 0, 0,
                             0, 1, -1, 1, -1, 1, -1, 1, -1, -1, 1, -1, 1};
__constant__ int c_cz[27] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, -1, -1,
                             1, 1, -1, -1, 1, 1, -1, -1, 1, 1, -1, -1, 1};
__constant__ int c_opp[27] = {0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14,
                              13, 16, 15, 18, 17, 20, 19, 22, 21, 24, 23, 26, 25};
__constant__ double c_w19[19] = {
    1.0 / 3.0,  1.0 / 18.0, 1.0 / 18.0, 1.0 / 18.0, 1.0 / 18.0,
    1.0 / 18.0, 1.0 / 18.0, 1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0,
    1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0,
    1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0};
__constant__ double c_w27[27] = {
    8.0 / 27.0,  2.0 / 27.0,  2.0 / 27.0,  2.0 / 27.0,  2.0 / 27.0,
    2.0 / 27.0,  2.0 / 27.0,  1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,
    1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,
    1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,  1.0 / 216.0,
    1.0 / 216.0, 1.0 / 216.0, 1.0 / 216.0, 1.0 / 216.0, 1.0 / 216.0,
    1.0 / 216.0, 1.0 / 216.0};

// Collision coefficients, passed by value: BGK uses om_a = om; TRT uses
// om_a = om_p, om_b = om_m. lid[q] = 6 w_q (c_q . u_wall).
template <typename T, int Q>
struct Coefs {
  T lid[Q];
  T om_a;
  T om_b;
};

__device__ __forceinline__ int wrap(int i, int n) {
  i += (i < 0) ? n : 0;
  return i - ((i >= n) ? n : 0);
}

template <typename T, int Q>
__device__ __forceinline__ T equilibrium(int q, T rho, T ux, T uy, T uz, T usq) {
  const T cu = T(0) + T(c_cx[q]) * ux + T(c_cy[q]) * uy + T(c_cz[q]) * uz;
  const T w = T(Q == 19 ? c_w19[q] : c_w27[q]);
  return w * rho * (T(1) + T(3) * cu + T(4.5) * cu * cu - T(1.5) * usq);
}

// TRT update of direction q whose opposite direction holds fo / feo.
template <typename T>
__device__ __forceinline__ T trt(T fq, T fo, T feq, T feo, T om_p, T om_m) {
  const T f_p = T(0.5) * (fq + fo);
  const T f_m = T(0.5) * (fq - fo);
  const T fe_p = T(0.5) * (feq + feo);
  const T fe_m = T(0.5) * (feq - feo);
  return fq - om_p * (f_p - fe_p) - om_m * (f_m - fe_m);
}

template <typename T, int Q, bool TRT>
__global__ void __launch_bounds__(kThreads)
    stream_collide_kernel(const T* __restrict__ f, const int32_t* __restrict__ mask,
                          T* __restrict__ out, int64_t total, int X, int Y, int Z,
                          Coefs<T, Q> k) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int64_t n = static_cast<int64_t>(X) * Y * Z;
  const int64_t b = idx / n;
  // one block's cell count fits 32 bits (the wrapper checks): only the
  // block index needs a 64-bit divide
  const int cell = static_cast<int>(idx - b * n);
  const int z = cell % Z;
  const int xy = cell / Z;
  const int y = xy % Y;
  const int x = xy / Y;
  const T* __restrict__ fb = f + b * Q * n;
  const int32_t* __restrict__ mb = mask + b * n;
  T* __restrict__ ob = out + b * Q * n;

  if (mb[cell] != kFluid) {
#pragma unroll
    for (int q = 0; q < Q; ++q) ob[q * n + cell] = fb[q * n + cell];
    return;
  }

  // pull streaming with halfway bounce-back (lid: velocity bounce-back)
  T fin[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int xs = wrap(x - c_cx[q], X);
    const int ys = wrap(y - c_cy[q], Y);
    const int zs = wrap(z - c_cz[q], Z);
    const int src = (xs * Y + ys) * Z + zs;
    const int ms = mb[src];
    if (ms == kFluid) {
      fin[q] = fb[q * n + src];
    } else {
      const T v = fb[c_opp[q] * n + cell];
      fin[q] = (ms == kLid) ? v + k.lid[q] : v;
    }
  }

  // moments, in the fixed q order of the Pallas body
  T rho = fin[0];
#pragma unroll
  for (int q = 1; q < Q; ++q) rho = rho + fin[q];
  T ux = T(0), uy = T(0), uz = T(0);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    ux = ux + T(c_cx[q]) * fin[q];
    uy = uy + T(c_cy[q]) * fin[q];
    uz = uz + T(c_cz[q]) * fin[q];
  }
  const T inv_rho = T(1) / rho;
  ux = ux * inv_rho;
  uy = uy * inv_rho;
  uz = uz * inv_rho;
  const T usq = ux * ux + uy * uy + uz * uz;

  if (!TRT) {
    const T om = k.om_a;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const T fe = equilibrium<T, Q>(q, rho, ux, uy, uz, usq);
      ob[q * n + cell] = fin[q] + om * (fe - fin[q]);
    }
  } else {
    const T om_p = k.om_a;
    const T om_m = k.om_b;
    const T fe0 = equilibrium<T, Q>(0, rho, ux, uy, uz, usq);
    ob[cell] = trt(fin[0], fin[0], fe0, fe0, om_p, om_m);
#pragma unroll
    for (int q = 1; q < Q; q += 2) {
      const int r = q + 1;  // opposite(q)
      const T fe_q = equilibrium<T, Q>(q, rho, ux, uy, uz, usq);
      const T fe_r = equilibrium<T, Q>(r, rho, ux, uy, uz, usq);
      ob[q * n + cell] = trt(fin[q], fin[r], fe_q, fe_r, om_p, om_m);
      ob[r * n + cell] = trt(fin[r], fin[q], fe_r, fe_q, om_p, om_m);
    }
  }
}

// Write the valid rows of the padded (B, P, Q) ghost slab into the flat
// cells halo_cell[b, p] of block b of f, in place. Invalid (pad) rows are
// skipped: the Pallas kernel wrote the centre cell's own value back there.
template <typename T, int Q>
__global__ void __launch_bounds__(kThreads)
    halo_fill_kernel(T* __restrict__ f, const T* __restrict__ vals,
                     const int32_t* __restrict__ cell, const uint8_t* __restrict__ valid,
                     int64_t rows, int P, int64_t n) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows || !valid[row]) return;
  const int64_t b = row / P;
  T* __restrict__ fb = f + b * Q * n + cell[row];
  const T* __restrict__ v = vals + row * Q;
#pragma unroll
  for (int q = 0; q < Q; ++q) fb[q * n] = v[q];
}

int64_t grid_for(int64_t items) { return (items + kThreads - 1) / kThreads; }

template <typename T, int Q, bool TRT>
cudaError_t launch_stencil(const void* f, const void* mask, void* out, int64_t B, int X,
                           int Y, int Z, double om_a, double om_b, const double* lid,
                           cudaStream_t stream) {
  Coefs<T, Q> k;
  for (int q = 0; q < Q; ++q) k.lid[q] = static_cast<T>(lid[q]);
  k.om_a = static_cast<T>(om_a);
  k.om_b = static_cast<T>(om_b);
  const int64_t total = B * X * Y * Z;
  const int64_t grid = grid_for(total);
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  stream_collide_kernel<T, Q, TRT><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const int32_t*>(mask), static_cast<T*>(out),
      total, X, Y, Z, k);
  return cudaGetLastError();
}

template <typename T, int Q>
cudaError_t launch_fill(void* f, const void* vals, const void* cell, const void* valid,
                        int64_t B, int P, int64_t n, cudaStream_t stream) {
  const int64_t rows = B * P;
  const int64_t grid = grid_for(rows);
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  halo_fill_kernel<T, Q><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<T*>(f), static_cast<const T*>(vals), static_cast<const int32_t*>(cell),
      static_cast<const uint8_t*>(valid), rows, P, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_stencil(int Q, int trt, const void* f, const void* mask, void* out,
                             int64_t B, int X, int Y, int Z, double om_a, double om_b,
                             const double* lid, cudaStream_t s) {
  if (Q == 19 && trt) return launch_stencil<T, 19, true>(f, mask, out, B, X, Y, Z, om_a, om_b, lid, s);
  if (Q == 19) return launch_stencil<T, 19, false>(f, mask, out, B, X, Y, Z, om_a, om_b, lid, s);
  if (Q == 27 && trt) return launch_stencil<T, 27, true>(f, mask, out, B, X, Y, Z, om_a, om_b, lid, s);
  if (Q == 27) return launch_stencil<T, 27, false>(f, mask, out, B, X, Y, Z, om_a, om_b, lid, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_fill(int Q, void* f, const void* vals, const void* cell, const void* valid,
                          int64_t B, int P, int64_t n, cudaStream_t s) {
  if (Q == 19) return launch_fill<T, 19>(f, vals, cell, valid, B, P, n, s);
  if (Q == 27) return launch_fill<T, 27>(f, vals, cell, valid, B, P, n, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float64. trt: 0 = BGK (om_a = om), 1 = TRT
// (om_a = om_p, om_b = om_m). lid: host array of Q values. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lbm_stream_collide(int dtype, int Q, int trt, const void* f, const void* mask,
                                  void* out, long long B, int X, int Y, int Z, double om_a,
                                  double om_b, const double* lid, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (B * X * Y * Z == 0) return cudaSuccess;
  if (dtype == 0) return dispatch_stencil<float>(Q, trt, f, mask, out, B, X, Y, Z, om_a, om_b, lid, s);
  if (dtype == 1) return dispatch_stencil<double>(Q, trt, f, mask, out, B, X, Y, Z, om_a, om_b, lid, s);
  return cudaErrorInvalidValue;
}

// The halo variant: fill the ghost slab into f in place, then the stencil.
// halo_vals (B, P, Q) of f's dtype, halo_cell (B, P) int32, halo_valid
// (B, P) bool (one byte each).
extern "C" int lbm_stream_collide_halo(int dtype, int Q, int trt, void* f, const void* mask,
                                       const void* halo_vals, const void* halo_cell,
                                       const void* halo_valid, int P, void* out, long long B,
                                       int X, int Y, int Z, double om_a, double om_b,
                                       const double* lid, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t n = static_cast<int64_t>(X) * Y * Z;
  if (B * n == 0) return cudaSuccess;
  cudaError_t err = cudaErrorInvalidValue;
  if (P > 0) {
    if (dtype == 0) err = dispatch_fill<float>(Q, f, halo_vals, halo_cell, halo_valid, B, P, n, s);
    if (dtype == 1) err = dispatch_fill<double>(Q, f, halo_vals, halo_cell, halo_valid, B, P, n, s);
    if (err != cudaSuccess) return err;
  }
  return lbm_stream_collide(dtype, Q, trt, f, mask, out, B, X, Y, Z, om_a, om_b, lid, stream);
}
