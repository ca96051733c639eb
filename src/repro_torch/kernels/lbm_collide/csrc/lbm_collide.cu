// Fused D3Q19/D3Q27 stream+collide and the ghost fill for Hopper (sm_90a),
// written by hand.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   * stream_collide_kernel <- repro/kernels/lbm_collide/lbm_collide.py
//                              lbm_stream_collide_pallas (_kernel ->
//                              _stream_collide_body)
//   * stream_collide_kernel's HALO instantiations (the fused, serving and
//     rank paths), or halo_fill_kernel then stream_collide_kernel (the slab
//     interface)
//                           <- lbm_stream_collide_halo_pallas (_halo_kernel)
//
// What bounds both: bytes. Per cell the stencil reads Q pdfs and one int32
// cell type and writes Q pdfs, about 4 flops per byte moved, far below the
// H100's ratio of peak flops to HBM bandwidth (about 20 for fp32). The fill
// copies (or, for a fine source, averages 8 cells into) one ghost cell's Q
// values. So the only number that matters is how close each comes to moving
// each byte once at 3.35 TB/s.
//
// Stencil design:
//   * A 3-D grid: one CTA per (z/y tile of one x-plane, x, block b), threads
//     over (z, y) with z innermost. A tile spans the whole z extent when it
//     can, so a CTA's rows are contiguous in memory and a warp's q-plane
//     accesses are too. No thread divides: the CTA's tile origin costs one
//     uniform division.
//   * The CTA stages its mask tile with the one-cell ring (3 x (TY+2) x
//     (TZ+2) cells) in shared memory as uint8, wrapped at the block edge as
//     jnp.roll wraps. Each direction reads its source's type from there.
//   * The pulled source index wraps inside the block, so it is always valid:
//     the Q pulled loads f_q(x - c_q) are issued first, without condition,
//     all in flight together with the loads of the CTA's mask tile, which
//     the thread then stages. Where a source is not fluid (its type read
//     from shared memory), the bounce-back value f_opp(q)(x) is loaded in
//     place of the pulled one. No pdf load depends on another global load.
//   * Few registers stay live while the loads are in flight: an offset is a
//     CTA-uniform part plus one wrap correction an axis, and outputs go
//     through a pointer bumped one q-plane a direction. __launch_bounds__
//     caps the f32 D3Q19 stencil at 64 registers, 4 CTAs of 256 threads
//     (50 % occupancy) on an SM, with nothing spilled to local memory.
//   * rho and u are summed in registers in the fixed q order of the Pallas
//     body; feq is recomputed per direction instead of being stored.
//     Non-fluid cells copy their input. The ghost ring is stream-collided
//     too, with wrapped values, exactly like the oracle.
//   * The lattice tables are compile-time constants folded into the
//     unrolled loops. The collision
//     coefficients (om, or om_p/om_m, and the lid vector) arrive as kernel
//     arguments, already rounded to the working type on the host.
//   * A slot list (the SLOTS instantiations) lets one launch step a subset
//     of a stack's blocks in place of a gathered sub-stack: grid z indexes
//     the list, and block slots[z] of f is read and of out written. The
//     rank-sharded engine steps its interior blocks, then its boundary
//     blocks, into one output tensor this way, through a halo map where the
//     level has fill rows (SLOTS and HALO together).
//   * A member axis (the MEMBERS instantiations) steps M ensemble members
//     that share one forest in one launch: f and out are (M * B, Q, X, Y, Z)
//     views of an (M, B, ...) stack, grid z covers all M * B blocks, block
//     b is member b / B and reads mask block b % B (the mask stack is
//     shared). Each member's coefficients (lid[Q], om_a, om_b) are a row of
//     a device table; the member index is uniform over a CTA, so the CTA
//     stages its row in shared memory once, and the by-value coefficient
//     struct is never indexed by a runtime member. A batch of M members
//     thus launches what one member's step launches.
//
// Fill design. The TPU kernel filled and stepped in one kernel, from a
// padded (B, P, Q) slab of ghost values a block, because one grid step
// owned one block; on the card that slab is pure traffic. The halo route
// (the HALO instantiations) folds the fill into the stencil instead, and
// replaces the separate fill launches of the fused, serving and rank paths:
//   * what bounds a separate fill is the z faces. The layout is (B, Q, X,
//     Y, Z) with z fastest, so a z-face ghost cell and its source each lie
//     alone in a 32-byte sector of every q-plane: on a 34^3 block those
//     rows are 31 % of the ring's but touch 70 % of its sectors, and a
//     partly written sector is read and written back. No thread mapping of
//     a separate pass makes them contiguous. Only the stencil's full-z tile
//     already holds a row's two z-face cells, in sectors it loads anyway;
//   * so the HALO stencil writes no ghost cell: it reads each pulled value
//     whose source cell has a fill row from that row's source (one cell, or
//     an octet's mean) in the pre-step stacks. A per-level map (B, X, Y, Z)
//     of 64-bit row sources (segment, fine flag, element offset) is copied
//     with cp.async into shared memory as the mask tile's twin before any
//     other load, and a redirected load is one load that nothing waits on
//     until the moments, so the redirects of every direction overlap;
//   * the source of a z-face ghost cell is a row its z-neighbour block's
//     CTA reads whole. The grid runs the CTAs of 8 consecutive blocks (a
//     Morton octet) at one x plane together, so that source is an L2 hit;
//     more blocks a plane lose the stencil's own reuse of x planes in L2;
//   * the redirect code is inlined at every direction, so it is kept short
//     (a thread's own filled values come through a pointer chosen once, a
//     fine row's octet means staged in its own output slots, and only where
//     the cell reads them, which the host marks in the map): a larger
//     kernel cost more in instruction fetch than the redirects themselves;
//   * the output equals the fill then the stencil bitwise, ghost ring
//     included: the stencil's arithmetic is the same code, and the fill's
//     arithmetic is repeated exactly;
//   * a rank's inbound halo messages are segments too: a received (N, Q)
//     payload, whose row i holds direction q at element i Q + q, is a
//     segment of direction stride 1 (a stack's is X Y Z), and a message row
//     is a copy row at offset row Q. So a rank's level, its local rows and
//     the rows of every payload that reaches it, is one launch; a message
//     row is read where the stencil pulls it, as a local row is, and no
//     ghost cell of the pre-step buffers is written. A stride read from
//     the segment cost a stacks-only launch (fused) 0.7 % against the
//     constant X Y Z, so the launcher takes the PAYLOADS instantiations,
//     which read it, only where a segment is a payload. Over a slot list
//     (SLOTS and HALO) the listed blocks read the map at their own slots:
//     a rank's interior half before its messages arrive, then its
//     boundary half with the payloads bound;
//   * what bounds the rank route beyond the whole-stack route is its
//     launch groups: kHaloGroup consecutive slot-list entries run
//     together, and a rank's stack is not octet-aligned while the split
//     cuts octets apart, so a group of consecutive entries rarely holds a
//     block's z- and y-neighbours (3 of 16 groups of a rank's level-2
//     stack were whole octets, none of its boundary half's). The host
//     lists each half, and an unsplit rank level whole, in neighbour
//     order (whole octets first, then groups grown by shared faces, z
//     first), which took the boundary half from 42 to 45 % of its byte
//     bound and the unsplit level from 42 to 45 %, the whole-stack
//     route's share (PERF.md, section 6). The payload rows are not what
//     bounds it: read direction-major, fully coalesced, they gained
//     nothing, so they are read where the stencil pulls them, as a
//     stack's rows are, and not staged in shared memory.
// The separate fill (the slab interface) reads its sources directly:
//   * one thread per ghost row, rows sorted by (dst slot, dst cell) on the
//     host, so for each q a warp's loads and stores fall on neighbouring
//     cells of one q-plane; index arrays are int32;
//   * "copy" rows (same-level and coarse sources) copy one cell's Q values,
//     "fine" rows sum the 8 octet cells in canonical order and multiply by
//     1/8 with round-to-nearest intrinsics (nothing contracted or
//     reordered: bitwise the plain version's arithmetic), "values" rows read
//     a row of an (N, Q) array (the slab interface, where a valid byte a row
//     skips the pad rows; with a null valid array every row is written);
//   * it writes into the ghost ring of the destination buffer in place. A
//     fill racing a stencil's read would be wrong, so the launch boundary
//     orders them; fill targets are ghost cells and fill sources interior
//     cells, so fills of several levels never read what another wrote;
//   * grid y is the member axis: member m of an ensemble's (M, B, ...)
//     stacks offsets dst and src by m whole member stacks, and all members
//     share one set of index tables (grid y = 1 for a solo fill).
//
// C interface: plain functions taking raw pointers and the CUDA stream,
// returning cudaGetLastError() as an int, loaded from Python with ctypes.
//
// Parts: the build compiles this source once for each (dtype, Q) pair, all
// at once, into a library a pair (LBM_PART_DTYPE: 0 float, 1 double;
// LBM_PART_Q: 19 or 27), so that the build takes the longest part's time,
// not the sum of all. A part instantiates only its pair's kernels, and its
// entry points refuse another pair (cudaErrorInvalidValue). Both macros are
// required.

#include <cuda_runtime.h>

#include <cstdint>

#if !defined(LBM_PART_DTYPE) || !defined(LBM_PART_Q)
#error "compile one (dtype, Q) part: define LBM_PART_DTYPE (0 or 1) and LBM_PART_Q (19 or 27)"
#endif
#define LBM_F32 (LBM_PART_DTYPE == 0)
#define LBM_F64 (LBM_PART_DTYPE == 1)
#define LBM_Q19 (LBM_PART_Q == 19)
#define LBM_Q27 (LBM_PART_Q == 27)

namespace {

constexpr int kThreads = 256;
constexpr int kFluid = 0;
constexpr int kLid = 2;
// mask tile bytes: 3 x (TY+2) x (TZ+2) with TY*TZ <= kThreads is largest at
// TY = 1, TZ = 256 (or the reverse): 3 x 3 x 258
constexpr int kMaskTile = 3 * (kThreads + 2 * (kThreads + 1) + 4);
// mask rows a stencil thread stages through registers (3 * (TY + 2) rows
// over TY threads: 4 for the 34^3 blocks' TY = 7)
constexpr int kStagedRows = 4;
constexpr int kFillCopy = 0;
constexpr int kFillFine = 1;
constexpr int kFillValues = 2;

// D3Q27 velocities; D3Q19 is its first 19 entries. The ordering pairs each
// direction q >= 1 with its opposite: opposite(q) = q + 1 for odd q, q - 1
// for even q (opposite_of and the TRT loop below rely on that pairing).
// Every use of a table sits in a fully unrolled loop over q, so each entry
// folds into the instruction that uses it (a product with a velocity
// component becomes a copy, a negation or a zero, all exact). Tables in
// __constant__ memory cost a load and an int->float conversion a use, held
// in registers, and made the f32 D3Q19 stencil spill at its 64-register cap.
__device__ __forceinline__ int cx_of(int q) {
  constexpr int c_cx[27] = {0, 1, -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1,
                            -1, 0, 0, 0, 0, 1, -1, 1, -1, 1, -1, 1, -1};
  return c_cx[q];
}
__device__ __forceinline__ int cy_of(int q) {
  constexpr int c_cy[27] = {0, 0, 0, 1, -1, 0, 0, 1, -1, -1, 1, 0, 0, 0,
                            0, 1, -1, 1, -1, 1, -1, 1, -1, -1, 1, -1, 1};
  return c_cy[q];
}
__device__ __forceinline__ int cz_of(int q) {
  constexpr int c_cz[27] = {0, 0, 0, 0, 0, 1, -1, 0, 0, 0, 0, 1, -1, -1,
                            1, 1, -1, -1, 1, 1, -1, -1, 1, 1, -1, -1, 1};
  return c_cz[q];
}
template <int Q>
__device__ __forceinline__ double weight_of(int q) {
  constexpr double c_w19[19] = {
      1.0 / 3.0,  1.0 / 18.0, 1.0 / 18.0, 1.0 / 18.0, 1.0 / 18.0,
      1.0 / 18.0, 1.0 / 18.0, 1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0,
      1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0,
      1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0, 1.0 / 36.0};
  constexpr double c_w27[27] = {
      8.0 / 27.0,  2.0 / 27.0,  2.0 / 27.0,  2.0 / 27.0,  2.0 / 27.0,
      2.0 / 27.0,  2.0 / 27.0,  1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,
      1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,
      1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,  1.0 / 54.0,  1.0 / 216.0,
      1.0 / 216.0, 1.0 / 216.0, 1.0 / 216.0, 1.0 / 216.0, 1.0 / 216.0,
      1.0 / 216.0, 1.0 / 216.0};
  return Q == 19 ? c_w19[q] : c_w27[q];
}

// The opposite of direction q, as a compile-time index so that register
// arrays indexed by it stay in registers.
__host__ __device__ constexpr int opposite_of(int q) {
  return q == 0 ? 0 : ((q & 1) ? q + 1 : q - 1);
}

// Least CTAs of kThreads threads an SM must hold: 4 (50 % occupancy, 64
// registers a thread) for the f32 D3Q19 stencil of the main path; the wider
// D3Q27 and f64 instantiations keep the registers they need instead.
template <typename T, int Q>
constexpr int stencil_min_ctas() {
  return sizeof(T) == 4 ? (Q == 19 ? 4 : 2) : 1;
}

// Collision coefficients, passed by value: BGK uses om_a = om; TRT uses
// om_a = om_p, om_b = om_m. lid[q] = 6 w_q (c_q . u_wall).
template <typename T, int Q>
struct Coefs {
  T lid[Q];
  T om_a;
  T om_b;
};

// The member axis of the MEMBERS instantiations: grid z covers blocks b0 ..
// of an (M * B)-block stack; coef is the device table (M, Q + 2) of each
// member's lid[Q], om_a, om_b in the working type. Unused (null) otherwise.
template <typename T>
struct Members {
  const T* coef;
  int B;
  int b0;
};

// Least CTAs of kThreads threads an SM must hold for the HALO
// instantiations: the stencil's 4 (64 registers a thread) for f32 D3Q19,
// which holds with no spill, and 2 for f32 D3Q27.
template <typename T, int Q>
constexpr int halo_min_ctas() {
  return sizeof(T) == 4 ? (Q == 19 ? 4 : 2) : 1;
}

// The HALO operand: where each ghost cell's filled value comes from. map
// (B, X, Y, Z) holds, at each cell that has a fill row, seg << kSegShift |
// fine << kFineBit | stage << kStageBit | the element offset of the row's
// source cell (direction 0) in segment seg's source stack, and -1 at every
// other cell. stage marks a fine row whose cell reads its own values (it is
// not fluid, or a neighbour is not: bounce-back), set by the host from the
// mask.
// A copy row's value of direction q is the element q qstride further on
// (qstride: X Y Z in a stack, 1 in an (N, Q) payload); a fine row's is the
// mean of the octet starting there (offsets 0, 1, Z, Z + 1, YZ, ..., YZ +
// Z + 1: the canonical order), always in a stack. src is the segment's
// pre-step stack of member 0 or a payload, mstride the elements between
// two members' stacks. A rank's level takes its local kinds (at most 3)
// and one segment a payload that reaches it; the segment field's 5 bits
// (58 to 62) bound the count at 32.
constexpr int kHaloSegs = 32;
// The HALO grid order: the CTAs of kHaloGroup consecutive blocks (a Morton
// octet) at one x plane run together, then the next plane, then the next
// group. The z-face source rows a block's ghost cells read are rows its
// z-neighbours' CTAs read whole at the same time, so they are L2 hits; a
// group of 1 (the stencil's order) or of a whole level's blocks was slower
// (PERF.md, section 6). The launcher sets Halo::group to it. Over a slot
// list the groups are kHaloGroup consecutive entries, which the host
// orders so that they are neighbours.
constexpr int kHaloGroup = 8;
constexpr int kSegShift = 58;
constexpr int kFineBit = 57;
constexpr int kStageBit = 56;
constexpr int64_t kOffMask = (int64_t{1} << kStageBit) - 1;

template <typename T>
struct HaloSeg {
  const T* src;
  int64_t mstride;
  int64_t qstride;
};

// A segment as a CTA stages it in shared memory: its member's source and
// its direction stride, one 16-byte load a redirect.
template <typename T>
struct alignas(16) HaloSrc {
  const T* src;
  int q;
};

template <typename T>
struct Halo {
  const int64_t* map;  // (B, X, Y, Z) of the level's blocks (shared by members)
  HaloSeg<T> seg[kHaloSegs];
  int nseg;   // segments in use
  int group;  // kHaloGroup: the tiles of `group` blocks fastest, then x, then the block group
  int tiles;  // tiles a block plane
  int count;  // SLOTS: the slot-list entries of the launch's chunk
};

// An 8-byte copy from global to shared memory that bypasses the registers
// (cp.async, sm_80 and later), and the wait for all of a thread's copies.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// i in [-n, 2n): one period either way. A neighbour of a cell of the block,
// and a cell of a mask tile (TY <= Y and TZ <= Z, so a tile and its ring
// overhang the block by at most one period), are both in range.
__device__ __forceinline__ int wrap(int i, int n) {
  i += (i < 0) ? n : 0;
  return i - ((i >= n) ? n : 0);
}

template <typename T, int Q>
__device__ __forceinline__ T equilibrium(int q, T rho, T ux, T uy, T uz, T usq) {
  const T cu = T(0) + T(cx_of(q)) * ux + T(cy_of(q)) * uy + T(cz_of(q)) * uz;
  const T w = T(weight_of<Q>(q));
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

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// The filled value of direction q of the cell whose row source is e: one
// load (copy), or the octet's 8 loads summed in the canonical order and
// times 1/8 with round-to-nearest intrinsics (fine), bitwise the fill
// kernel's and the plain fill's arithmetic. It is inlined at every
// direction of the stencil's loop and in the own-value prologue only, so
// that the kernel stays about 1.4 times the stencil's size: inlined at
// every bounce-back as well, it made the kernel 1.7 times the stencil and
// its instruction fetch cost a fifth of the member route's time. The
// octet's 8 loads are issued together before the ordered sum: a fine row
// waits for one round trip, not for eight.
template <typename T, bool PAYLOADS>
__device__ __forceinline__ T halo_value(const HaloSrc<T>* segs, int64_t e, int q, int n, int Z, int YZ) {
  const HaloSrc<T> s = segs[e >> kSegShift];
  const T* __restrict__ p = s.src + (e & kOffMask) + static_cast<int64_t>(q) * (PAYLOADS ? s.q : n);
  if (!((e >> kFineBit) & 1)) return *p;
  // the 8 loads first, all in flight together, then the sum in order
  T v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = p[(k >> 2) * YZ + ((k >> 1) & 1) * Z + (k & 1)];
  T acc = v[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) acc = add_rn(acc, v[k]);
  return mul_rn(acc, T(0.125));
}

// blockDim = (TZ, TY); grid = (tiles_y * tiles_z, X, B), or (..., X, S) over
// a slot list of S entries, each in [0, nblocks) (checked; others step
// nothing), or (..., X, chunk) over an M-member stack from block mem.b0 on.
// HALO: (tiles_y * tiles_z * h.group, X, block groups of a chunk), the
// groups over h.count slot-list entries with SLOTS. PAYLOADS: some segment
// is a payload, so each segment's direction stride is read (else it is n).
template <typename T, int Q, bool TRT, bool SLOTS, bool MEMBERS, bool HALO, bool PAYLOADS>
__global__ void __launch_bounds__(kThreads, (HALO ? halo_min_ctas<T, Q>() : stencil_min_ctas<T, Q>()))
    stream_collide_kernel(const T* __restrict__ f, const int32_t* __restrict__ mask,
                          T* __restrict__ out, const int32_t* __restrict__ slots,
                          int nblocks, int X, int Y, int Z, int tiles_z, Coefs<T, Q> k,
                          Members<T> mem, Halo<T> h) {
  static_assert(!(SLOTS && MEMBERS), "a slot list and a member axis do not combine");
  static_assert(!PAYLOADS || (HALO && !MEMBERS), "payload segments need a halo map and no member axis");
  __shared__ uint8_t tile[kMaskTile];
  // the CTA's member's coefficients (lid[Q], om_a, om_b); a placeholder in
  // the solo instantiations, which read k instead
  __shared__ T mcoef[MEMBERS ? Q + 2 : 1];
  // HALO: the wrapped tile of row sources (laid out as the mask tile, in
  // dynamic shared memory sized to it) and the CTA's segments, each source
  // offset to its member
  extern __shared__ int64_t hsrc[];
  __shared__ HaloSrc<T> hseg[HALO ? kHaloSegs : 1];
  const int TZ = blockDim.x;
  const int TY = blockDim.y;
  int ty_tile = blockIdx.x / tiles_z;  // uniform over the CTA
  int z0 = (blockIdx.x - ty_tile * tiles_z) * TZ;
  int y0 = ty_tile * TY;
  const int x = blockIdx.y;
  const int n = X * Y * Z;  // the wrapper checks that it fits 31 bits
  int64_t b = blockIdx.z;
  int64_t b_mask = b;
  int member = 0;
  // HALO: grid (tiles * group, X, groups); the CTA's block (or slot-list
  // entry) of the chunk
  unsigned hb = blockIdx.z;
  if constexpr (HALO) {
    const unsigned bg = blockIdx.x / h.tiles;  // one uniform division a CTA
    hb = blockIdx.z * h.group + bg;
    if (hb >= static_cast<unsigned>(SLOTS ? h.count : nblocks)) return;  // the last group's missing blocks
    ty_tile = (blockIdx.x - bg * h.tiles) / tiles_z;
    z0 = (blockIdx.x - bg * h.tiles - ty_tile * tiles_z) * TZ;
    y0 = ty_tile * TY;
    b = hb;
    b_mask = b;
  }
  if (SLOTS) {
    b = slots[HALO ? hb : blockIdx.z];
    if (b < 0 || b >= nblocks) return;  // uniform over the CTA
    b_mask = b;
  }
  if constexpr (MEMBERS) {
    // member and mask block: one uniform 32-bit division a CTA
    const int bm = static_cast<int>(HALO ? hb : blockIdx.z) + mem.b0;
    const int m = bm / mem.B;
    b = bm;
    b_mask = bm - m * mem.B;
    member = m;
    // the row is staged before the __syncthreads that publishes the mask
    // tile, and read only after it
    const T* __restrict__ row = mem.coef + m * (Q + 2);
    for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < Q + 2; i += blockDim.x * blockDim.y) mcoef[i] = row[i];
  }
  if constexpr (HALO) {
    // the CTA's segments, each offset to its member, staged by one thread
    // before the mask and pdf loads: each entry of the by-value struct is read at a
    // compile-time index (a runtime index would copy it to local memory),
    // and only the h.nseg in use
    if (threadIdx.x == 0 && threadIdx.y == 0) {
#pragma unroll
      for (int s = 0; s < kHaloSegs; ++s) {
        if (s == h.nseg) break;
        const HaloSeg<T> seg = h.seg[s];
        hseg[s] = HaloSrc<T>{seg.src + member * seg.mstride, static_cast<int>(seg.qstride)};
      }
    }
  }
  const T* __restrict__ fb = f + b * Q * n;
  const int32_t* __restrict__ mb = mask + b_mask * n;
  T* __restrict__ ob = out + b * Q * n;

  const int y = y0 + threadIdx.y;
  const int z = z0 + threadIdx.x;
  const bool inside = y < Y && z < Z;  // a tile may overhang the block
  const int cell = (x * Y + y) * Z + z;
  const T* __restrict__ fc = fb + cell;

  // the wrapped mask tile: planes x-1, x, x+1, rows y0-1 .. y0+TY, columns
  // z0-1 .. z0+TZ. Thread (tz, ty) stages rows ty, ty + TY, ... and columns
  // tz and tz + TZ. The loads of its first kStagedRows rows are issued now,
  // into registers, so they are in flight together with the pdf loads below.
  const int SZ = TZ + 2;
  const int SY = TY + 2;
  if constexpr (HALO) {
    // the map's tile, as the mask's, copied to shared memory without
    // registers before any other load, so that it lands while the pdf
    // loads fly
    const int64_t* __restrict__ hb = h.map + b_mask * n;
    for (int r = threadIdx.y; r < 3 * SY; r += TY) {
      const int dx = r / SY;
      const int64_t* __restrict__ row = hb + (wrap(x + dx - 1, X) * Y + wrap(y0 + (r - dx * SY) - 1, Y)) * Z;
      for (int c = threadIdx.x; c < SZ; c += TZ) cp_async8(&hsrc[r * SZ + c], row + wrap(z0 + c - 1, Z));
    }
  }
  int staged[kStagedRows][2];
#pragma unroll
  for (int j = 0; j < kStagedRows; ++j) {
    const int r = threadIdx.y + j * TY;
    const int dx = (r >= SY) + (r >= 2 * SY);
    const int32_t* __restrict__ row =
        mb + (wrap(x + dx - 1, X) * Y + wrap(y0 + (r - dx * SY) - 1, Y)) * Z;
    const bool live = r < 3 * SY;
    staged[j][0] = live ? row[wrap(z0 + threadIdx.x - 1, Z)] : 0;
    staged[j][1] = (live && threadIdx.x + TZ < SZ) ? row[wrap(z0 + threadIdx.x + TZ - 1, Z)] : 0;
  }

  // pull streaming, first half: the Q pulled values f_q(x - c_q), issued
  // right behind the mask-tile loads. The wrap keeps every source inside
  // the block, so
  // none of them waits on a condition or on another load, and their
  // latency overlaps the mask staging.
  const int YZ = Y * Z;
  // one wrap correction an axis: + a period on the low edge (where c = +1
  // pulls from below 0), - a period on the high edge (extents are >= 2)
  const int wx = (x == 0) ? n : ((x == X - 1) ? -n : 0);
  const int wy = (y == 0) ? YZ : ((y == Y - 1) ? -YZ : 0);
  const int wz = (z == 0) ? Z : ((z == Z - 1) ? -Z : 0);
  T fin[Q];
  if (inside) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int cx = cx_of(q), cy = cy_of(q), cz = cz_of(q);
      fin[q] = fc[q * n - (cx * YZ + cy * Z + cz) + (cx * wx > 0 ? wx : 0) + (cy * wy > 0 ? wy : 0) +
                  (cz * wz > 0 ? wz : 0)];
    }
  }

  // store the staged rows. Columns beyond the two staged ones (TZ = 1) and
  // rows beyond kStagedRows (tiles of few rows) are loaded and stored here.
  auto stage_direct = [&](int r, int c_begin) {
    const int dx = r / SY;
    const int32_t* __restrict__ row =
        mb + (wrap(x + dx - 1, X) * Y + wrap(y0 + (r - dx * SY) - 1, Y)) * Z;
    for (int c = c_begin; c < SZ; c += TZ) tile[r * SZ + c] = static_cast<uint8_t>(row[wrap(z0 + c - 1, Z)]);
  };
#pragma unroll
  for (int j = 0; j < kStagedRows; ++j) {
    const int r = threadIdx.y + j * TY;
    if (r < 3 * SY) {
      tile[r * SZ + threadIdx.x] = static_cast<uint8_t>(staged[j][0]);
      if (threadIdx.x + TZ < SZ) tile[r * SZ + threadIdx.x + TZ] = static_cast<uint8_t>(staged[j][1]);
      if (threadIdx.x + 2 * TZ < SZ) stage_direct(r, threadIdx.x + 2 * TZ);
    }
  }
  for (int r = threadIdx.y + kStagedRows * TY; r < 3 * SY; r += TY) stage_direct(r, threadIdx.x);
  if constexpr (HALO) cp_async_wait_all();  // this thread's share of the map tile has landed
  __syncthreads();
  if (!inside) return;

  // outputs go through a pointer bumped by one q-plane a direction, so no
  // store address stays live
  T* __restrict__ o = ob + cell;
  const int centre = (SY + threadIdx.y + 1) * SZ + threadIdx.x + 1;
  // HALO: where the thread's own values come from (they are read where the
  // cell is not fluid or bounces back), fq elements apart: its row's source
  // cell for a copy row (a payload row's directions are adjacent); for a
  // fine row marked stage its Q octet means, staged in the cell's own
  // output slots, which the step overwrites last. The Q means wait on Q
  // round trips in turn, so only the fine cells that read them (few: most
  // are fluid among fluid) stage them; an unmarked fine cell never reads
  // fcb.
  const T* fcb = fc;
  int fq = n;
  if constexpr (HALO) {
    const int64_t own = hsrc[centre];
    if (own >= 0) {
      const HaloSrc<T> s = hseg[own >> kSegShift];
      if ((own >> kStageBit) & 1) {
        T* st = ob + cell;
#pragma unroll 1
        for (int q = 0; q < Q; ++q) st[q * n] = halo_value<T, PAYLOADS>(hseg, own, q, n, Z, YZ);
        fcb = st;
      } else {
        fcb = s.src + (own & kOffMask);
        if constexpr (PAYLOADS) fq = s.q;
      }
    }
  }
  if (tile[centre] != kFluid) {
#pragma unroll
    for (int q = 0; q < Q; ++q, o += n) *o = fcb[q * fq];
    return;
  }

  // second half: halfway bounce-back (lid: velocity bounce-back) where the
  // source is not fluid. Its type comes from shared memory, so the
  // bounce-back loads f_opp(q)(x) depend on no global load either.
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int ms = tile[centre - (cx_of(q) * SY + cy_of(q)) * SZ - cz_of(q)];
    if (ms != kFluid) {
      fin[q] = fcb[opposite_of(q) * fq];  // replaces the dead pulled value
      if (ms == kLid) {
        if constexpr (MEMBERS) {
          fin[q] = fin[q] + mcoef[q];
        } else {
          fin[q] = fin[q] + k.lid[q];
        }
      }
    } else if constexpr (HALO) {
      // a fluid source with a fill row: its value comes from the row's
      // source, one load that nothing waits on until the moments, so the
      // redirected loads of every direction are in flight together
      const int64_t e = hsrc[centre - (cx_of(q) * SY + cy_of(q)) * SZ - cz_of(q)];
      if (e >= 0) fin[q] = halo_value<T, PAYLOADS>(hseg, e, q, n, Z, YZ);
    }
  }

  // moments, in the fixed q order of the Pallas body
  T rho = fin[0];
#pragma unroll
  for (int q = 1; q < Q; ++q) rho = rho + fin[q];
  T ux = T(0), uy = T(0), uz = T(0);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    ux = ux + T(cx_of(q)) * fin[q];
    uy = uy + T(cy_of(q)) * fin[q];
    uz = uz + T(cz_of(q)) * fin[q];
  }
  const T inv_rho = T(1) / rho;
  ux = ux * inv_rho;
  uy = uy * inv_rho;
  uz = uz * inv_rho;
  const T usq = ux * ux + uy * uy + uz * uz;

  T om_a = k.om_a, om_b = k.om_b;
  if constexpr (MEMBERS) {
    om_a = mcoef[Q];
    om_b = mcoef[Q + 1];
  }
  if (!TRT) {
    const T om = om_a;
#pragma unroll
    for (int q = 0; q < Q; ++q, o += n) {
      const T fe = equilibrium<T, Q>(q, rho, ux, uy, uz, usq);
      *o = fin[q] + om * (fe - fin[q]);
    }
  } else {
    const T om_p = om_a;
    const T om_m = om_b;
    const T fe0 = equilibrium<T, Q>(0, rho, ux, uy, uz, usq);
    *o = trt(fin[0], fin[0], fe0, fe0, om_p, om_m);
    o += n;
#pragma unroll
    for (int q = 1; q < Q; q += 2) {
      const int r = opposite_of(q);  // q + 1
      const T fe_q = equilibrium<T, Q>(q, rho, ux, uy, uz, usq);
      const T fe_r = equilibrium<T, Q>(r, rho, ux, uy, uz, usq);
      *o = trt(fin[q], fin[r], fe_q, fe_r, om_p, om_m);
      o += n;
      *o = trt(fin[r], fin[q], fe_r, fe_q, om_p, om_m);
      o += n;
    }
  }
}

// Fill `rows` ghost cells of dst (B_dst, Q, n) in place: row i writes cell
// dst_cell[i] of block dst_slot[i]. Its value comes, by KIND, from cell
// src_cell[i] of block src_slot[i] of src (copy), from the mean of the 8
// cells src_cell[i, 0..7] of block src_slot[i] (fine), or from row i of an
// (N, Q) array src, skipped where valid[i] is 0 unless valid is null
// (values). dst and src may be
// the same buffer: sources are interior cells, targets ghost cells, so no
// location is both read and written. Grid y is the member: dst and src
// advance by dst_mstride and src_mstride elements a member (0 for values).
template <typename T, int Q, int KIND>
__global__ void __launch_bounds__(kThreads)
    halo_fill_kernel(T* __restrict__ dst, const T* __restrict__ src, int64_t rows, int n,
                     const int32_t* __restrict__ dst_slot, const int32_t* __restrict__ dst_cell,
                     const int32_t* __restrict__ src_slot, const int32_t* __restrict__ src_cell,
                     const uint8_t* __restrict__ valid, int64_t dst_mstride, int64_t src_mstride) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  if (KIND == kFillValues && valid != nullptr && !valid[row]) return;
  dst += blockIdx.y * dst_mstride;
  src += blockIdx.y * src_mstride;
  T* __restrict__ d = dst + static_cast<int64_t>(dst_slot[row]) * Q * n + dst_cell[row];
  if (KIND == kFillCopy) {
    const T* __restrict__ s = src + static_cast<int64_t>(src_slot[row]) * Q * n + src_cell[row];
#pragma unroll
    for (int q = 0; q < Q; ++q) d[q * n] = s[q * n];
  } else if (KIND == kFillFine) {
    const T* __restrict__ s = src + static_cast<int64_t>(src_slot[row]) * Q * n;
    const int* __restrict__ oct = src_cell + row * 8;
    const int c0 = oct[0], c1 = oct[1], c2 = oct[2], c3 = oct[3];
    const int c4 = oct[4], c5 = oct[5], c6 = oct[6], c7 = oct[7];
    // one q at a time: 8 loads in flight a thread, and no spills at Q = 27
#pragma unroll 1
    for (int q = 0; q < Q; ++q) {
      const T* __restrict__ sq = s + q * n;
      T acc = sq[c0];  // the canonical octet order, summed in that order
      acc = add_rn(acc, sq[c1]);
      acc = add_rn(acc, sq[c2]);
      acc = add_rn(acc, sq[c3]);
      acc = add_rn(acc, sq[c4]);
      acc = add_rn(acc, sq[c5]);
      acc = add_rn(acc, sq[c6]);
      acc = add_rn(acc, sq[c7]);
      d[q * n] = mul_rn(acc, T(0.125));
    }
  } else {
    const T* __restrict__ s = src + row * Q;
#pragma unroll
    for (int q = 0; q < Q; ++q) d[q * n] = s[q];
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The stencil's CTA shape: z tiles as wide as Z allows, then as many y rows
// as fit; both balanced so the last tile overhangs the block as little as
// it can.
struct StencilTiles {
  int TZ, TY, tiles_z, tiles_y;
  StencilTiles(int Y, int Z) {
    tiles_z = ceil_div(Z, kThreads);
    TZ = ceil_div(Z, tiles_z);
    TY = kThreads / TZ < Y ? kThreads / TZ : Y;
    tiles_y = ceil_div(Y, TY);
    TY = ceil_div(Y, tiles_y);
  }
};

constexpr int64_t kMaxGridZ = 65535;

// B blocks of f, or the S = B entries of slots (non-null) into a stack of
// nblocks blocks.
template <typename T, int Q, bool TRT>
cudaError_t launch_stencil(const void* f, const void* mask, void* out, const void* slots,
                           int64_t nblocks, int64_t B, int X, int Y, int Z, double om_a,
                           double om_b, const double* lid, cudaStream_t stream) {
  Coefs<T, Q> k;
  for (int q = 0; q < Q; ++q) k.lid[q] = static_cast<T>(lid[q]);
  k.om_a = static_cast<T>(om_a);
  k.om_b = static_cast<T>(om_b);
  const StencilTiles t(Y, Z);
  const int64_t n = static_cast<int64_t>(X) * Y * Z;
  const Members<T> none{nullptr, 0, 0};
  const Halo<T> no_halo{};
  if (X > 65535 || nblocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  for (int64_t b0 = 0; b0 < B; b0 += kMaxGridZ) {
    const int64_t nb = B - b0 < kMaxGridZ ? B - b0 : kMaxGridZ;
    const dim3 grid(t.tiles_y * t.tiles_z, X, static_cast<unsigned>(nb));
    if (slots != nullptr) {
      stream_collide_kernel<T, Q, TRT, true, false, false, false><<<grid, dim3(t.TZ, t.TY), 0, stream>>>(
          static_cast<const T*>(f), static_cast<const int32_t*>(mask), static_cast<T*>(out),
          static_cast<const int32_t*>(slots) + b0, static_cast<int>(nblocks), X, Y, Z, t.tiles_z, k, none, no_halo);
    } else {
      stream_collide_kernel<T, Q, TRT, false, false, false, false><<<grid, dim3(t.TZ, t.TY), 0, stream>>>(
          static_cast<const T*>(f) + b0 * Q * n, static_cast<const int32_t*>(mask) + b0 * n,
          static_cast<T*>(out) + b0 * Q * n, nullptr, static_cast<int>(nb), X, Y, Z, t.tiles_z, k, none, no_halo);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// M members of B blocks each: f and out hold M * B blocks, mask B, coef the
// (M, Q + 2) table.
template <typename T, int Q, bool TRT>
cudaError_t launch_stencil_members(const void* f, const void* mask, void* out, const void* coef,
                                   int64_t M, int64_t B, int X, int Y, int Z, cudaStream_t stream) {
  const StencilTiles t(Y, Z);
  const int64_t total = M * B;
  if (X > 65535 || total > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const Coefs<T, Q> unused{};
  for (int64_t b0 = 0; b0 < total; b0 += kMaxGridZ) {
    const int64_t nb = total - b0 < kMaxGridZ ? total - b0 : kMaxGridZ;
    const dim3 grid(t.tiles_y * t.tiles_z, X, static_cast<unsigned>(nb));
    const Members<T> mem{static_cast<const T*>(coef), static_cast<int>(B), static_cast<int>(b0)};
    stream_collide_kernel<T, Q, TRT, false, true, false, false><<<grid, dim3(t.TZ, t.TY), 0, stream>>>(
        static_cast<const T*>(f), static_cast<const int32_t*>(mask), static_cast<T*>(out), nullptr,
        static_cast<int>(total), X, Y, Z, t.tiles_z, unused, mem, Halo<T>{});
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The HALO stencil: B blocks of f stepped into out (coef null, coefficients
// k), the S entries of a slot list into f's B blocks (slots non-null), or M
// members of B blocks each (coef the (M, Q + 2) device table), the ghost
// values read through h. Grid (tiles * kHaloGroup, X, groups) in chunks of
// at most kMaxGridZ groups: the CTAs of kHaloGroup blocks (or consecutive
// slot-list entries) at one x plane run together. PAYLOADS: some segment is
// an (N, Q) payload (not with members).
template <typename T, int Q, bool TRT, bool PAYLOADS>
cudaError_t launch_stencil_halo(const void* f, const void* mask, void* out, const void* slots, int64_t S,
                                const void* coef, int64_t M, int64_t B, int X, int Y, int Z,
                                const Coefs<T, Q>& k, Halo<T> h, cudaStream_t stream) {
  const StencilTiles t(Y, Z);
  h.tiles = t.tiles_y * t.tiles_z;
  h.group = kHaloGroup;
  const int64_t total = slots != nullptr ? S : (coef != nullptr ? M : 1) * B;
  const size_t smem = sizeof(int64_t) * 3 * (t.TY + 2) * (t.TZ + 2);  // the map's tile
  const int64_t chunk = kMaxGridZ * kHaloGroup;
  if (X > 65535 || total > 0x7fffffff || B > 0x7fffffff || static_cast<int64_t>(h.tiles) * kHaloGroup > 0x7fffffff)
    return cudaErrorInvalidConfiguration;
  const dim3 block(t.TZ, t.TY);
  for (int64_t b0 = 0; b0 < total; b0 += chunk) {
    const int64_t nb = total - b0 < chunk ? total - b0 : chunk;
    const dim3 grid(h.tiles * kHaloGroup, X, static_cast<unsigned>((nb + kHaloGroup - 1) / kHaloGroup));
    if (slots != nullptr) {
      // the chunk's entries index the whole stack, whose operands (map
      // included) stay whole
      Halo<T> hc = h;
      hc.count = static_cast<int>(nb);
      stream_collide_kernel<T, Q, TRT, true, false, true, PAYLOADS><<<grid, block, smem, stream>>>(
          static_cast<const T*>(f), static_cast<const int32_t*>(mask), static_cast<T*>(out),
          static_cast<const int32_t*>(slots) + b0, static_cast<int>(B), X, Y, Z, t.tiles_z, k,
          Members<T>{nullptr, 0, 0}, hc);
    } else if (coef != nullptr) {
      if constexpr (PAYLOADS) {
        return cudaErrorInvalidValue;
      } else {
        const Members<T> mem{static_cast<const T*>(coef), static_cast<int>(B), static_cast<int>(b0)};
        stream_collide_kernel<T, Q, TRT, false, true, true, false><<<grid, block, smem, stream>>>(
            static_cast<const T*>(f), static_cast<const int32_t*>(mask), static_cast<T*>(out), nullptr,
            static_cast<int>(nb), X, Y, Z, t.tiles_z, k, mem, h);
      }
    } else {
      // a solo chunk offsets its block operands, map included; the
      // segments' offsets address whole source stacks
      const int64_t n = static_cast<int64_t>(X) * Y * Z;
      Halo<T> hc = h;
      hc.map += b0 * n;
      stream_collide_kernel<T, Q, TRT, false, false, true, PAYLOADS><<<grid, block, smem, stream>>>(
          static_cast<const T*>(f) + b0 * Q * n, static_cast<const int32_t*>(mask) + b0 * n,
          static_cast<T*>(out) + b0 * Q * n, nullptr, static_cast<int>(nb), X, Y, Z, t.tiles_z, k,
          Members<T>{nullptr, 0, 0}, hc);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Fill args shared by every kind: members (grid y) and each member's stride
// in dst and in src, in elements.
struct FillMembers {
  int M;
  int64_t dst_stride;
  int64_t src_stride;
};

template <typename T, int Q, int KIND>
cudaError_t launch_fill(void* dst, const void* src, int64_t rows, int n, const void* dst_slot,
                        const void* dst_cell, const void* src_slot, const void* src_cell,
                        const void* valid, FillMembers mem, cudaStream_t stream) {
  const int64_t grid = (rows + kThreads - 1) / kThreads;
  if (grid > 0x7fffffff || mem.M < 1 || mem.M > 65535) return cudaErrorInvalidConfiguration;
  halo_fill_kernel<T, Q, KIND><<<dim3(static_cast<unsigned>(grid), mem.M), kThreads, 0, stream>>>(
      static_cast<T*>(dst), static_cast<const T*>(src), rows, n,
      static_cast<const int32_t*>(dst_slot), static_cast<const int32_t*>(dst_cell),
      static_cast<const int32_t*>(src_slot), static_cast<const int32_t*>(src_cell),
      static_cast<const uint8_t*>(valid), mem.dst_stride, mem.src_stride);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_members(int Q, int trt, const void* f, const void* mask, void* out,
                             const void* coef, int64_t M, int64_t B, int X, int Y, int Z, cudaStream_t s) {
#if LBM_Q19
  if (Q == 19 && trt) return launch_stencil_members<T, 19, true>(f, mask, out, coef, M, B, X, Y, Z, s);
  if (Q == 19) return launch_stencil_members<T, 19, false>(f, mask, out, coef, M, B, X, Y, Z, s);
#endif
#if LBM_Q27
  if (Q == 27 && trt) return launch_stencil_members<T, 27, true>(f, mask, out, coef, M, B, X, Y, Z, s);
  if (Q == 27) return launch_stencil_members<T, 27, false>(f, mask, out, coef, M, B, X, Y, Z, s);
#endif
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_stencil(int Q, int trt, const void* f, const void* mask, void* out,
                             const void* slots, int64_t nblocks, int64_t B, int X, int Y, int Z,
                             double om_a, double om_b, const double* lid, cudaStream_t s) {
#if LBM_Q19
  if (Q == 19 && trt)
    return launch_stencil<T, 19, true>(f, mask, out, slots, nblocks, B, X, Y, Z, om_a, om_b, lid, s);
  if (Q == 19)
    return launch_stencil<T, 19, false>(f, mask, out, slots, nblocks, B, X, Y, Z, om_a, om_b, lid, s);
#endif
#if LBM_Q27
  if (Q == 27 && trt)
    return launch_stencil<T, 27, true>(f, mask, out, slots, nblocks, B, X, Y, Z, om_a, om_b, lid, s);
  if (Q == 27)
    return launch_stencil<T, 27, false>(f, mask, out, slots, nblocks, B, X, Y, Z, om_a, om_b, lid, s);
#endif
  return cudaErrorInvalidValue;
}

// The operands of one HALO launch beyond the coefficients.
struct HaloLaunch {
  const void* f;
  const void* mask;
  void* out;
  const void* slots;
  int64_t S;
  const void* coef;
  int64_t M;
  int64_t B;
  int X, Y, Z;
};

template <typename T, int Q, bool TRT>
cudaError_t dispatch_halo_p(bool payloads, const HaloLaunch& a, const Coefs<T, Q>& k, const Halo<T>& h,
                            cudaStream_t s) {
  if (payloads)
    return launch_stencil_halo<T, Q, TRT, true>(a.f, a.mask, a.out, a.slots, a.S, a.coef, a.M, a.B, a.X, a.Y, a.Z, k, h, s);
  return launch_stencil_halo<T, Q, TRT, false>(a.f, a.mask, a.out, a.slots, a.S, a.coef, a.M, a.B, a.X, a.Y, a.Z, k, h, s);
}

template <typename T, int Q>
cudaError_t dispatch_halo_q(int trt, bool payloads, const HaloLaunch& a, double om_a, double om_b,
                            const double* lid, const Halo<T>& h, cudaStream_t s) {
  Coefs<T, Q> k;
  for (int q = 0; q < Q; ++q) k.lid[q] = static_cast<T>(lid[q]);
  k.om_a = static_cast<T>(om_a);
  k.om_b = static_cast<T>(om_b);
  if (trt) return dispatch_halo_p<T, Q, true>(payloads, a, k, h, s);
  return dispatch_halo_p<T, Q, false>(payloads, a, k, h, s);
}

template <typename T>
cudaError_t dispatch_halo(int Q, int trt, const HaloLaunch& a, double om_a, double om_b, const double* lid,
                          const void* map, int nseg, const void* const* seg_src, const long long* seg_mstride,
                          const long long* seg_qstride, cudaStream_t s) {
  Halo<T> h{};
  h.map = static_cast<const int64_t*>(map);
  h.nseg = nseg;
  // a stack's direction stride is the block's cells; any other is a payload's
  const int64_t n = static_cast<int64_t>(a.X) * a.Y * a.Z;
  bool payloads = false;
  for (int i = 0; i < nseg; ++i) {
    h.seg[i] = HaloSeg<T>{static_cast<const T*>(seg_src[i]), seg_mstride[i], seg_qstride[i]};
    payloads = payloads || seg_qstride[i] != n;
  }
#if LBM_Q19
  if (Q == 19) return dispatch_halo_q<T, 19>(trt, payloads, a, om_a, om_b, lid, h, s);
#endif
#if LBM_Q27
  if (Q == 27) return dispatch_halo_q<T, 27>(trt, payloads, a, om_a, om_b, lid, h, s);
#endif
  return cudaErrorInvalidValue;
}

template <typename T, int Q>
cudaError_t dispatch_fill_kind(int kind, void* dst, const void* src, int64_t rows, int n,
                               const void* ds, const void* dc, const void* ss, const void* sc,
                               const void* valid, FillMembers m, cudaStream_t s) {
  if (kind == kFillCopy) return launch_fill<T, Q, kFillCopy>(dst, src, rows, n, ds, dc, ss, sc, valid, m, s);
  if (kind == kFillFine) return launch_fill<T, Q, kFillFine>(dst, src, rows, n, ds, dc, ss, sc, valid, m, s);
  if (kind == kFillValues) return launch_fill<T, Q, kFillValues>(dst, src, rows, n, ds, dc, ss, sc, valid, m, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_fill(int Q, int kind, void* dst, const void* src, int64_t rows, int n,
                          const void* ds, const void* dc, const void* ss, const void* sc,
                          const void* valid, FillMembers m, cudaStream_t s) {
#if LBM_Q19
  if (Q == 19) return dispatch_fill_kind<T, 19>(kind, dst, src, rows, n, ds, dc, ss, sc, valid, m, s);
#endif
#if LBM_Q27
  if (Q == 27) return dispatch_fill_kind<T, 27>(kind, dst, src, rows, n, ds, dc, ss, sc, valid, m, s);
#endif
  return cudaErrorInvalidValue;
}

// Registers, local (spill) bytes, static shared bytes and resident CTAs of
// kThreads threads per SM of one kernel instantiation.
template <typename K>
cudaError_t attrs_of(K kernel, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = ctas;
  out[4] = kThreads;
  return cudaSuccess;
}

template <typename T, int Q>
cudaError_t attrs_q(int which, int variant, int* out) {
  if (which == 0) {
    switch (variant) {
      case 0: return attrs_of(stream_collide_kernel<T, Q, false, false, false, false, false>, out);
      case 1: return attrs_of(stream_collide_kernel<T, Q, true, false, false, false, false>, out);
      case 2: return attrs_of(stream_collide_kernel<T, Q, false, true, false, false, false>, out);
      case 3: return attrs_of(stream_collide_kernel<T, Q, true, true, false, false, false>, out);
      case 4: return attrs_of(stream_collide_kernel<T, Q, false, false, true, false, false>, out);
      case 5: return attrs_of(stream_collide_kernel<T, Q, true, false, true, false, false>, out);
      case 8: return attrs_of(stream_collide_kernel<T, Q, false, false, false, true, false>, out);
      case 9: return attrs_of(stream_collide_kernel<T, Q, true, false, false, true, false>, out);
      case 10: return attrs_of(stream_collide_kernel<T, Q, false, true, false, true, false>, out);
      case 11: return attrs_of(stream_collide_kernel<T, Q, true, true, false, true, false>, out);
      case 12: return attrs_of(stream_collide_kernel<T, Q, false, false, true, true, false>, out);
      case 13: return attrs_of(stream_collide_kernel<T, Q, true, false, true, true, false>, out);
      case 24: return attrs_of(stream_collide_kernel<T, Q, false, false, false, true, true>, out);
      case 25: return attrs_of(stream_collide_kernel<T, Q, true, false, false, true, true>, out);
      case 26: return attrs_of(stream_collide_kernel<T, Q, false, true, false, true, true>, out);
      case 27: return attrs_of(stream_collide_kernel<T, Q, true, true, false, true, true>, out);
      default: return cudaErrorInvalidValue;
    }
  }
  if (variant == kFillCopy) return attrs_of(halo_fill_kernel<T, Q, kFillCopy>, out);
  if (variant == kFillFine) return attrs_of(halo_fill_kernel<T, Q, kFillFine>, out);
  if (variant == kFillValues) return attrs_of(halo_fill_kernel<T, Q, kFillValues>, out);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float64. trt: 0 = BGK (om_a = om), 1 = TRT
// (om_a = om_p, om_b = om_m). f, mask and out hold nblocks blocks; slots is
// null (step blocks 0 .. B-1, B = nblocks) or a device array of B int32
// block indices (step those). lid: host array of Q values. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int lbm_stream_collide(int dtype, int Q, int trt, const void* f, const void* mask,
                                  void* out, const void* slots, long long nblocks, long long B,
                                  int X, int Y, int Z, double om_a, double om_b, const double* lid,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (B * X * Y * Z == 0) return cudaSuccess;
#if LBM_F32
  if (dtype == 0)
    return dispatch_stencil<float>(Q, trt, f, mask, out, slots, nblocks, B, X, Y, Z, om_a, om_b, lid, s);
#endif
#if LBM_F64
  if (dtype == 1)
    return dispatch_stencil<double>(Q, trt, f, mask, out, slots, nblocks, B, X, Y, Z, om_a, om_b, lid, s);
#endif
  return cudaErrorInvalidValue;
}

// The member axis of the stencil: f and out are (M * B, Q, X, Y, Z) views of
// M members' stacks, mask (B, X, Y, Z) is shared by every member, and coef
// is a device array (M, Q + 2) in the working type holding each member's
// lid[Q], om_a, om_b (BGK: om_b unused). Returns the cudaError_t of the
// launch.
extern "C" int lbm_stream_collide_members(int dtype, int Q, int trt, const void* f, const void* mask,
                                          void* out, const void* coef, long long M, long long B,
                                          int X, int Y, int Z, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (M * B * X * Y * Z == 0) return cudaSuccess;
#if LBM_F32
  if (dtype == 0) return dispatch_members<float>(Q, trt, f, mask, out, coef, M, B, X, Y, Z, s);
#endif
#if LBM_F64
  if (dtype == 1) return dispatch_members<double>(Q, trt, f, mask, out, coef, M, B, X, Y, Z, s);
#endif
  return cudaErrorInvalidValue;
}

// The stencil with the ghost ring read through a halo map (halo in tile):
// f (B, Q, X, Y, Z) stepped into out, or only the S blocks a device array
// slots (S int32 entries, each in [0, B)) names (slots non-null, solo), or
// with coef (the member table) M members' stacks (M * B, ...) sharing mask
// and map. map: (B, X, Y, Z) int64, at each cell with a fill row seg << 58
// | fine << 57 | stage << 56 | the element offset of its source (direction
// 0; a fine row's octet base) in the segment's source, -1 elsewhere.
// Segment i (i < nseg <= 32): source seg_src[i] (member 0; a stack or an
// (N, Q) payload), seg_mstride[i] elements a member, seg_qstride[i]
// elements between two directions of a row. lid: host array of Q values
// (solo). Returns the cudaError_t of the launch.
extern "C" int lbm_stream_collide_halo_map(int dtype, int Q, int trt, const void* f, const void* mask, void* out,
                                           const void* slots, long long S, const void* coef, long long M,
                                           long long B, int X, int Y, int Z, double om_a, double om_b,
                                           const double* lid, const void* map, int nseg, const void* const* seg_src,
                                           const long long* seg_mstride, const long long* seg_qstride,
                                           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (nseg < 1 || nseg > kHaloSegs || (slots != nullptr && coef != nullptr)) return cudaErrorInvalidValue;
  if ((slots != nullptr ? S : (coef != nullptr ? M : 1) * B) * X * Y * Z == 0) return cudaSuccess;
  const HaloLaunch a{f, mask, out, slots, S, coef, M, B, X, Y, Z};
#if LBM_F32
  if (dtype == 0)
    return dispatch_halo<float>(Q, trt, a, om_a, om_b, lid, map, nseg, seg_src, seg_mstride, seg_qstride, s);
#endif
#if LBM_F64
  if (dtype == 1)
    return dispatch_halo<double>(Q, trt, a, om_a, om_b, lid, map, nseg, seg_src, seg_mstride, seg_qstride, s);
#endif
  return cudaErrorInvalidValue;
}

// The ghost fill, in place into dst. kind: 0 = copy (same-level and coarse
// sources; src_slot, src_cell (rows,)), 1 = fine (src_slot (rows,), src_cell
// (rows, 8)), 2 = values (src an (rows, Q) array; valid (rows,) bytes, or
// null: every row valid). All
// index arrays int32; n = cells of one block. members (grid y): the fill
// runs for each of them, member m's dst and src offset by m * dst_mstride
// and m * src_mstride elements (1, 0, 0 for one stack).
extern "C" int lbm_halo_fill(int dtype, int Q, int kind, void* dst, const void* src,
                             long long rows, int n, const void* dst_slot, const void* dst_cell,
                             const void* src_slot, const void* src_cell, const void* valid,
                             int members, long long dst_mstride, long long src_mstride,
                             void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaSuccess;
  const FillMembers m{members, dst_mstride, src_mstride};
#if LBM_F32
  if (dtype == 0) return dispatch_fill<float>(Q, kind, dst, src, rows, n, dst_slot, dst_cell, src_slot, src_cell, valid, m, s);
#endif
#if LBM_F64
  if (dtype == 1) return dispatch_fill<double>(Q, kind, dst, src, rows, n, dst_slot, dst_cell, src_slot, src_cell, valid, m, s);
#endif
  return cudaErrorInvalidValue;
}

// which: 0 = stencil (variant = trt + 2 * slots + 4 * members + 8 * halo + 16 * payloads), 1 = fill
// (variant = kind). out[5]:
// registers, local bytes, static shared bytes, CTAs per SM, threads per CTA.
extern "C" int lbm_kernel_attrs(int which, int dtype, int Q, int variant, int* out) {
#if LBM_F32 && LBM_Q19
  if (dtype == 0 && Q == 19) return attrs_q<float, 19>(which, variant, out);
#endif
#if LBM_F32 && LBM_Q27
  if (dtype == 0 && Q == 27) return attrs_q<float, 27>(which, variant, out);
#endif
#if LBM_F64 && LBM_Q19
  if (dtype == 1 && Q == 19) return attrs_q<double, 19>(which, variant, out);
#endif
#if LBM_F64 && LBM_Q27
  if (dtype == 1 && Q == 27) return attrs_q<double, 27>(which, variant, out);
#endif
  return cudaErrorInvalidValue;
}
