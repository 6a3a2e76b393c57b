// Dense and ragged clustered DWT / iDWT against a resident Wigner table,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/dwt.py:
//
//   dwt_dense   (_dwt_kernel)         out[k] = d[k] rhs[k]      (L x J)(J x C2)
//   idwt_dense  (_idwt_kernel)        g[k]   = d[k]^T lhs[k]    (J x L)(L x C2)
//   dwt_ragged  (_dwt_ragged_kernel)  dwt_dense on the host work list's
//                                     (cluster-tile, l-tile) blocks only
//
// Layout (row-major, contiguous): d (K, L, J), rhs (K, J, C2), lhs / out
// (K, L, C2), g (K, J, C2), with L = B, J = 2B and C2 = V * 16 lanes.  The
// ragged kernel's work list kk, ll (G,) int32 names, for entry g, the
// clusters kk[g]*tk .. kk[g]*tk+tk-1 of the launch order and the degrees
// ll[g]*tl .. ll[g]*tl+tl-1; launch cluster k reads the table row and the
// rhs row perm[k] and writes out row perm[k] (perm (K,) int32, or null for
// the identity), so no permuted copy of the table or of an operand is
// made.  Rows of out that no entry covers are not written.
//
// Every output element, on every body below, is ONE fma chain over the
// contraction index in ascending order from +0, whatever the tile, the
// stage or C2: lane k of a V-lane launch equals the single transform bit
// for bit, and the f64 forward's two bodies give the same bits.  The sums
// are in the input dtype, as the TPU kernels' accumulator.
//
// Which body runs what:
//
//  * f64 forward (dwt_dense_f64, dwt_ragged_f64): the FP64 tensor cores,
//    mma.sync.m16n8k4 (dense_fwd_dmma).  On the H100 one f64 mma is, bit
//    for bit, the ascending chain acc = fma(a_k, b_k, acc) over its k
//    (PERF.md §6, the probe), so walking j in ascending k-steps of 4
//    with one accumulator per output, chained over all of J from +0 (no
//    split-K, no partial sums across warps; zero table and rhs past J,
//    where fma(0, 0, acc) = acc) gives the scalar body's bits.  A block
//    of 256 threads owns BR = 128 rows of l by BC = 64 lanes of one
//    launch cluster (16 lanes, in 8-lane warp tiles, when C2 <= 16): 4 x 2
//    warps, each a 32 x 32 warp tile of 2 m-tiles by 4 n-tiles, 32
//    accumulator doubles a thread (128 registers, two blocks an SM, no
//    local memory).  The table chunk (BR x 16 j, contiguous along j in
//    d[k, l, :]) and the rhs chunk (16 j x BC) are copied with 16-byte
//    cp.async (asking L2 to fetch 256 B, the next stages' bytes, at once)
//    into a ring of 3 stages in dynamic shared memory (87 552 B),
//    one barrier a stage, two stages in flight while the third is
//    contracted; each thread copies from one base pointer a pass.  Rows
//    are padded to 20 / BC + 4 doubles (4 mod 16), so the fragment loads
//    (A: rows g and g + 8 at column t; B: row t at column g) fall in 16
//    distinct 8-byte banks per half-warp.  What bounds it: at B = 128,
//    f64, V = 8 (K = 8256, C2 = 128) one pass reads the 2.16 GB table and
//    the 2.16 GB rhs once and writes 1.08 GB, 1.6 ms at 3.35 TB/s,
//    against 69 GFLOP, 1.0 ms at the f64 tensor-core rate: bytes.  The
//    two lane tiles of a cluster are adjacent in the grid, so the second
//    reads the table rows from L2.  Measured (chip_smoke.py, NVIDIA H100
//    80GB HBM3, 700.00 W): PERF.md §6.
//    Ragged: a block starts at an entry g of the work list that begins a
//    run (the entry before it is not the same cluster tile's previous
//    l-tile) and covers the rows of the whole run, ll[g] tl up to the end
//    of its last consecutive l-tile, anchored there; other blocks exit at
//    once.  build_work_list gives each cluster tile one run (its l-tiles
//    tile_start .. L/tl - 1), so a cluster's rhs is staged once per lane
//    tile, not once per l-tile, and any other list is computed exactly
//    too (rows of a gap stay unwritten; a repeated entry is written twice
//    with the same bits).  Warp tiles whose rows all lie past the run
//    skip their mma, and no thread copies their table rows.
//    The 16-byte copies need d, rhs and out on 16-byte boundaries (the
//    wrapper checks).
//
//  * f32 (all three) and the f64 inverse: the scalar body on the FMA
//    pipes (dense_kernel; TF32 would keep 10 mantissa bits and lose
//    FP32_ROUNDTRIP_BOUNDS).  A block owns an output tile of one cluster:
//    BR = 16 TR rows (l forward, j inverse) by BC = 16 TQ lanes, 256
//    threads, thread (ty, tx) the TR x TQ elements rows ty + 16 i, lanes
//    tx + 16 q.  It walks the contraction axis (j forward, l inverse) in
//    rounds of kKC = 16: each round stages the table chunk, always as
//    As[t][r], and the operand chunk Bs[t][c] in shared memory, then every
//    thread adds a(t, r) * b(t, c) into its registers.  The inverse reads
//    the table chunk along its rows (coalesced) and so gets d^T without a
//    transposed copy in device memory.  What bounds it: two shared-memory
//    reads per four fma at TQ = TR = 4, on pipes of half the tensor-core
//    rate, so the pipes and the shared-memory reads, not the bytes (the
//    f64 inverse moves the same 5.4 GB as the forward; its DMMA redesign
//    is queued).  The blocks of one cluster are adjacent in the grid
//    (lanes fastest, then rows), so a table row read by the second lane
//    tile comes from L2.  The f64 forward instantiations of this body stay
//    exported as dwt_dense_f64_fma / dwt_ragged_f64_fma: a bit reference
//    for the tensor-core body on the card, called by no wrapper.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "dwt_block.cuh"  // repro::dmma

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 16;  // lane threads of a block
constexpr int kTY = 16;  // row threads of a block
constexpr int kKC = 16;  // contraction indices staged per round

template <typename T, int TR, int TQ>
struct Tile {
  static constexpr int BR = kTY * TR;  // output rows of a block
  static constexpr int BC = kTX * TQ;  // output lanes of a block
  static constexpr int AP = BR + 1;    // padded row of As (fewer bank conflicts on store)
};

// kTrans: the table is read transposed (the inverse).  kRagged: blocks are
// laid out over the work list (the ragged forward).
template <typename T, int TR, int TQ, bool kTrans, bool kRagged>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const T* __restrict__ d, const T* __restrict__ x, const int* __restrict__ kk,
             const int* __restrict__ ll, const int* __restrict__ perm, T* __restrict__ y,
             int nrows, int ncon, int J, int C2, int tk, int tl) {
  using Tl = Tile<T, TR, TQ>;
  __shared__ T As[kKC][Tl::AP];
  __shared__ T Bs[kKC][Tl::BC];

  const int nC = (C2 + Tl::BC - 1) / Tl::BC;
  const int span = kRagged ? tl : nrows;  // output rows of one unit
  const int nR = (span + Tl::BR - 1) / Tl::BR;
  long long bid = blockIdx.x;
  const int ct = int(bid % nC);
  bid /= nC;
  const int rt = int(bid % nR);
  const int unit = int(bid / nR);

  int kl = unit, rbeg = 0, rend = nrows;
  if constexpr (kRagged) {
    const int g = unit / tk;
    kl = kk[g] * tk + unit % tk;
    rbeg = ll[g] * tl;
    rend = min(rbeg + tl, nrows);
  }
  const int r0 = rbeg + rt * Tl::BR;
  if (r0 >= rend) return;
  const int row = perm ? perm[kl] : kl;
  const int c0 = ct * Tl::BC;
  const T* dk = d + size_t(row) * (kTrans ? ncon : nrows) * J;
  const T* xk = x + size_t(row) * ncon * C2;
  T* yk = y + size_t(row) * nrows * C2;

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  T acc[TR][TQ];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int q = 0; q < TQ; ++q) acc[i][q] = T(0);

  for (int t0 = 0; t0 < ncon; t0 += kKC) {
    for (int idx = threadIdx.x; idx < kKC * Tl::BR; idx += kThreads) {
      int rr, tt;
      if constexpr (kTrans) {  // d[k, t, r]: contiguous along r
        tt = idx / Tl::BR;
        rr = idx % Tl::BR;
      } else {  // d[k, r, t]: contiguous along t
        rr = idx / kKC;
        tt = idx % kKC;
      }
      const int r = r0 + rr, t = t0 + tt;
      T v = T(0);
      if (r < rend && t < ncon) v = kTrans ? dk[size_t(t) * J + r] : dk[size_t(r) * J + t];
      As[tt][rr] = v;
    }
    for (int idx = threadIdx.x; idx < kKC * Tl::BC; idx += kThreads) {
      const int tt = idx / Tl::BC, cc = idx % Tl::BC;
      const int t = t0 + tt, c = c0 + cc;
      Bs[tt][cc] = (t < ncon && c < C2) ? xk[size_t(t) * C2 + c] : T(0);
    }
    __syncthreads();
    const int nt = min(kKC, ncon - t0);
#pragma unroll
    for (int tt = 0; tt < kKC; ++tt) {
      if (tt < nt) {
        T a[TR], b[TQ];
#pragma unroll
        for (int i = 0; i < TR; ++i) a[i] = As[tt][ty + kTY * i];
#pragma unroll
        for (int q = 0; q < TQ; ++q) b[q] = Bs[tt][tx + kTX * q];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int q = 0; q < TQ; ++q) acc[i][q] = fma(a[i], b[q], acc[i][q]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = r0 + ty + kTY * i;
    if (r >= rend) continue;
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
      const int c = c0 + tx + kTX * q;
      if (c < C2) yk[size_t(r) * C2 + c] = acc[i][q];
    }
  }
}

// ---------------------------------------------------------------------------
// f64 forward: the DMMA body
// ---------------------------------------------------------------------------

using repro::kWarp;

constexpr int kRingThreads = 256;
constexpr int kRingKC = 16;     // j per ring stage (4 mma k-steps)
constexpr int kStages = 3;      // ring depth
constexpr int kWarpsM = 4;      // warps along l
constexpr int kWarpsN = 2;      // warps along the lanes
constexpr int kWarpRows = 32;   // l rows of a warp tile (2 m-tiles)
constexpr int kRingBR = kWarpsM * kWarpRows;  // 128 l rows of a block
constexpr int kRingPad = 4;     // row pad: strides = 4 mod 16 doubles

// WN lanes a warp (WN / 8 n-tiles), BC = 2 WN lanes a block.
template <int WN>
struct Ring {
  static constexpr int BC = kWarpsN * WN;
  static constexpr int NT = WN / 8;
  static constexpr int SA = kRingKC + kRingPad;  // table chunk row stride
  static constexpr int SB = BC + kRingPad;       // rhs chunk row stride
  static constexpr int kAElems = kRingBR * SA;
  static constexpr int kStage = kAElems + kRingKC * SB;
  static constexpr size_t kSmem = size_t(kStages) * kStage * sizeof(double);
  // 16-byte copies: a pass of the block copies 32 table rows (one warp
  // tile's) of a stage, or kBRows rhs rows
  static constexpr int kAPass = kRingThreads / (kRingKC / 2);
  static constexpr int kBRows = kRingThreads / (BC / 2);
  static constexpr int kBPasses = kBRows >= kRingKC ? 1 : kRingKC / kBRows;
  static_assert(SA % 16 == 4 && SB % 16 == 4, "fragment loads must be conflict-free");
  static_assert(kAPass == kWarpRows, "a table pass is one warp tile's rows");
};

// 16-byte copy global -> shared, with a 256-byte L2 prefetch; ok = false
// writes zeros and reads nothing.
__device__ __forceinline__ void ring_copy(double* dst, const double* src, bool ok) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void ring_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// all but the N most recently committed groups have landed
template <int N>
__device__ __forceinline__ void ring_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Entries of the run that starts at work-list entry g (cluster tile kt,
// l-tile lt): g, g + 1, ... while they name kt and lt, lt + 1, ...  Every
// warp computes it alike, 32 entries a ballot.
__device__ __forceinline__ int run_length(const int* __restrict__ kk, const int* __restrict__ ll,
                                          int g, int G, int kt, int lt) {
  const int lane = threadIdx.x % kWarp;
  for (int t0 = 1;; t0 += kWarp) {
    const int t = t0 + lane;
    const bool on = g + t < G && kk[g + t] == kt && ll[g + t] == lt + t;
    const unsigned miss = __ballot_sync(0xffffffffu, !on);
    if (miss) return t0 + __ffs(miss) - 1;
  }
}

template <int WN, bool kRagged>
__global__ void __launch_bounds__(kRingThreads, 2)
dense_fwd_dmma(const double* __restrict__ d, const double* __restrict__ x,
               const int* __restrict__ kk, const int* __restrict__ ll,
               const int* __restrict__ perm, double* __restrict__ y, int G, int L, int J, int C2,
               int tk, int tl) {
  using R = Ring<WN>;
  extern __shared__ __align__(16) double ring[];

  const int nC = (C2 + R::BC - 1) / R::BC;
  const int nR = (L + kRingBR - 1) / kRingBR;
  long long bid = blockIdx.x;
  const int ct = int(bid % nC);
  bid /= nC;
  const int rt = int(bid % nR);
  const int unit = int(bid / nR);

  int kl = unit, rbeg = 0, rend = L;
  if constexpr (kRagged) {
    const int g = unit / tk;
    const int kt = kk[g], lt = ll[g];
    if (g > 0 && kk[g - 1] == kt && ll[g - 1] + 1 == lt) return;  // inside a run
    kl = kt * tk + unit % tk;
    rbeg = lt * tl;
    rend = min((lt + run_length(kk, ll, g, G, kt, lt)) * tl, L);
  }
  const int r0 = rbeg + rt * kRingBR;
  if (r0 >= rend) return;
  const int row = perm ? perm[kl] : kl;
  const int c0 = ct * R::BC;
  // warp tiles (of 32 rows) with a row to store; the others skip their
  // mma, and no thread copies their table rows
  const int live = min((rend - r0 + kWarpRows - 1) / kWarpRows, kWarpsM);

  // This thread's 16-byte copies: table rows r0 + ar + 32 p (pass p) at
  // j0 + aj; rhs rows j0 + bj + kBRows p at lanes c0 + bc.  Zero past
  // rend, J and C2 (J and C2 are even: a pair never straddles an edge).
  const int ar = threadIdx.x / (kRingKC / 2), aj = 2 * (threadIdx.x % (kRingKC / 2));
  const int bj = threadIdx.x / (R::BC / 2), bc = 2 * (threadIdx.x % (R::BC / 2));
  const double* a_src = d + (size_t(row) * L + r0 + ar) * J + aj;
  const double* b_src = x + (size_t(row) * J + bj) * C2 + c0 + bc;
  const bool b_lane = c0 + bc < C2;
  auto load = [&](int s, int j0) {
    double* as = ring + s * R::kStage + ar * R::SA + aj;
    double* bs = ring + s * R::kStage + R::kAElems + bj * R::SB + bc;
#pragma unroll
    for (int p = 0; p < kWarpsM; ++p)
      if (p < live) {
        const bool ok = r0 + ar + kWarpRows * p < rend && j0 + aj < J;
        ring_copy(as + kWarpRows * p * R::SA, ok ? a_src + size_t(kWarpRows * p) * J + j0 : d,
                  ok);
      }
#pragma unroll
    for (int p = 0; p < R::kBPasses; ++p)
      if (bj < kRingKC) {
        const bool ok = b_lane && j0 + bj + R::kBRows * p < J;
        ring_copy(bs + R::kBRows * p * R::SB, ok ? b_src + size_t(j0 + R::kBRows * p) * C2 : x,
                  ok);
      }
  };

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int g = lane / 4, q = lane % 4;
  const int wr = r0 + wm * kWarpRows, wc = c0 + wn * WN;  // the warp tile's origin
  const bool active = wm < live && wc < C2;

  double acc[2][R::NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < R::NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0;

  const int nk = (J + kRingKC - 1) / kRingKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kRingKC);
    ring_commit();
  }
  const double* a_frag = ring + (wm * kWarpRows + g) * R::SA + q;
  const double* b_frag = ring + R::kAElems + q * R::SB + wn * WN + g;
  for (int kc = 0; kc < nk; ++kc) {
    ring_wait<kStages - 2>();  // chunk kc has landed (this thread's copies)
    __syncthreads();           // ... everyone's; and stage (kc - 1) % 3 is free
    if (kc + kStages - 1 < nk) load((kc + kStages - 1) % kStages, (kc + kStages - 1) * kRingKC);
    ring_commit();
    if (active) {
      const int st = (kc % kStages) * R::kStage;
#pragma unroll
      for (int ks = 0; ks < kRingKC / 4; ++ks) {
        double a[2][2], b[R::NT];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          a[mi][0] = a_frag[st + (16 * mi) * R::SA + 4 * ks];
          a[mi][1] = a_frag[st + (16 * mi + 8) * R::SA + 4 * ks];
        }
#pragma unroll
        for (int ni = 0; ni < R::NT; ++ni) b[ni] = b_frag[st + 4 * ks * R::SB + 8 * ni];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < R::NT; ++ni) repro::dmma(acc[mi][ni], a[mi][0], a[mi][1], b[ni]);
      }
    }
  }
  ring_wait<0>();  // no copy outlives the block

  if (!active) return;
  double* yk = y + (size_t(row) * L + wr) * C2 + wc + 2 * q;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mi + g + 8 * h;
      if (wr + r >= rend) continue;
#pragma unroll
      for (int ni = 0; ni < R::NT; ++ni)
        if (wc + 8 * ni + 2 * q < C2)
          *reinterpret_cast<double2*>(yk + size_t(r) * C2 + 8 * ni) =
              make_double2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* d;
  const void* x;
  const int* kk;
  const int* ll;
  const int* perm;
  void* y;
  int units, nrows, ncon, J, C2, tk, tl;
  cudaStream_t stream;
};

template <typename T, int TR, int TQ, bool kTrans, bool kRagged>
cudaError_t launch(const Args& a) {
  using Tl = Tile<T, TR, TQ>;
  const int span = kRagged ? a.tl : a.nrows;
  const long long blocks = (long long)a.units * ((span + Tl::BR - 1) / Tl::BR) *
                           ((a.C2 + Tl::BC - 1) / Tl::BC);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  dense_kernel<T, TR, TQ, kTrans, kRagged><<<unsigned(blocks), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.d), static_cast<const T*>(a.x), a.kk, a.ll, a.perm,
      static_cast<T*>(a.y), a.nrows, a.ncon, a.J, a.C2, a.tk, a.tl);
  return cudaGetLastError();
}

// The block tile follows the rows one unit covers and the lane count:
// 16 rows (lanes) per block when there are no more, else 64.  The fma
// chain of an element does not depend on the choice.
template <typename T, bool kTrans, bool kRagged>
cudaError_t pick(const Args& a) {
  const int span = kRagged ? a.tl : a.nrows;
  if (span <= kTY) {
    if (a.C2 <= kTX) return launch<T, 1, 1, kTrans, kRagged>(a);
    return launch<T, 1, 4, kTrans, kRagged>(a);
  }
  if (a.C2 <= kTX) return launch<T, 4, 1, kTrans, kRagged>(a);
  return launch<T, 4, 4, kTrans, kRagged>(a);
}

template <int WN, bool kRagged>
cudaError_t launch_dmma(const Args& a) {
  using R = Ring<WN>;
  const auto kern = dense_fwd_dmma<WN, kRagged>;
  const long long blocks = (long long)a.units * ((a.nrows + kRingBR - 1) / kRingBR) *
                           ((a.C2 + R::BC - 1) / R::BC);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(R::kSmem));
  if (err != cudaSuccess) return err;
  kern<<<unsigned(blocks), kRingThreads, R::kSmem, a.stream>>>(
      static_cast<const double*>(a.d), static_cast<const double*>(a.x), a.kk, a.ll, a.perm,
      static_cast<double*>(a.y), a.units / a.tk, a.nrows, a.J, a.C2, a.tk, a.tl);
  return cudaGetLastError();
}

// The lane tile follows C2: 64 lanes (two blocks per cluster at V = 8,
// adjacent in the grid, so the second reads the table rows from L2), or
// 16 for one transform.  The fma chain of an element does not depend on
// the choice.
template <bool kRagged>
cudaError_t pick_dmma(const Args& a) {
  const uintptr_t addr = uintptr_t(a.d) | uintptr_t(a.x) | uintptr_t(a.y);
  if (addr % 16 || a.J % 2 || a.C2 % 2) return cudaErrorInvalidValue;
  if (a.C2 <= 16) return launch_dmma<8, kRagged>(a);
  return launch_dmma<32, kRagged>(a);
}

template <typename Kern>
long long static_smem(Kern kern) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, kern) == cudaSuccess ? (long long)attr.sharedSizeBytes : -1;
}

// Shared memory of the scalar variant a launch with this span and C2
// takes, as the compiled kernel reports it (all static).
template <typename T, bool kTrans>
long long smem_of(int span, int C2) {
  if (span <= kTY)
    return C2 <= kTX ? static_smem(dense_kernel<T, 1, 1, kTrans, false>)
                     : static_smem(dense_kernel<T, 1, 4, kTrans, false>);
  return C2 <= kTX ? static_smem(dense_kernel<T, 4, 1, kTrans, false>)
                   : static_smem(dense_kernel<T, 4, 4, kTrans, false>);
}

// The DMMA forward's: static as compiled plus the ring's dynamic bytes.
template <int WN>
long long smem_dmma() {
  const long long st = static_smem(dense_fwd_dmma<WN, false>);
  return st < 0 ? -1 : st + (long long)Ring<WN>::kSmem;
}

bool bad(int K, int L, int J, int C2) { return K <= 0 || L <= 0 || J <= 0 || C2 <= 0; }

// fma = true takes the scalar body for the f64 forward too (the bit
// reference of the check symbols).
template <typename T>
int dense(bool inverse, const void* d, const void* x, void* y, int K, int L, int J, int C2,
          void* stream, bool fma = false) {
  if (bad(K, L, J, C2)) return int(cudaErrorInvalidValue);
  Args a{d, x, nullptr, nullptr, nullptr, y, K, inverse ? J : L, inverse ? L : J, J, C2, 1, 1,
         static_cast<cudaStream_t>(stream)};
  if (inverse) return int(pick<T, true, false>(a));
  if (sizeof(T) == 8 && !fma) return int(pick_dmma<false>(a));
  return int(pick<T, false, false>(a));
}

template <typename T>
int ragged(const void* d, const void* rhs, const void* kk, const void* ll, const void* perm,
           void* out, int G, int L, int J, int C2, int tk, int tl, void* stream,
           bool fma = false) {
  if (bad(G, L, J, C2) || tk <= 0 || tl <= 0) return int(cudaErrorInvalidValue);
  Args a{d, rhs, static_cast<const int*>(kk), static_cast<const int*>(ll),
         static_cast<const int*>(perm), out, G * tk, L, J, J, C2, tk, tl,
         static_cast<cudaStream_t>(stream)};
  if (sizeof(T) == 8 && !fma) return int(pick_dmma<true>(a));
  return int(pick<T, false, true>(a));
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of the launch (0 = queued on `stream`).
int dwt_dense_f32(const void* d, const void* rhs, void* out, int K, int L, int J, int C2,
                  void* stream) {
  return dense<float>(false, d, rhs, out, K, L, J, C2, stream);
}

int dwt_dense_f64(const void* d, const void* rhs, void* out, int K, int L, int J, int C2,
                  void* stream) {
  return dense<double>(false, d, rhs, out, K, L, J, C2, stream);
}

int idwt_dense_f32(const void* d, const void* lhs, void* g, int K, int L, int J, int C2,
                   void* stream) {
  return dense<float>(true, d, lhs, g, K, L, J, C2, stream);
}

int idwt_dense_f64(const void* d, const void* lhs, void* g, int K, int L, int J, int C2,
                   void* stream) {
  return dense<double>(true, d, lhs, g, K, L, J, C2, stream);
}

// perm may be null (identity).
int dwt_ragged_f32(const void* d, const void* rhs, const void* kk, const void* ll,
                   const void* perm, void* out, int G, int L, int J, int C2, int tk, int tl,
                   void* stream) {
  return ragged<float>(d, rhs, kk, ll, perm, out, G, L, J, C2, tk, tl, stream);
}

int dwt_ragged_f64(const void* d, const void* rhs, const void* kk, const void* ll,
                   const void* perm, void* out, int G, int L, int J, int C2, int tk, int tl,
                   void* stream) {
  return ragged<double>(d, rhs, kk, ll, perm, out, G, L, J, C2, tk, tl, stream);
}

// The f64 forward on the scalar FMA body: the tensor-core body's bit
// reference on the card.  No wrapper calls these.
int dwt_dense_f64_fma(const void* d, const void* rhs, void* out, int K, int L, int J, int C2,
                      void* stream) {
  return dense<double>(false, d, rhs, out, K, L, J, C2, stream, true);
}

int dwt_ragged_f64_fma(const void* d, const void* rhs, const void* kk, const void* ll,
                       const void* perm, void* out, int G, int L, int J, int C2, int tk, int tl,
                       void* stream) {
  return ragged<double>(d, rhs, kk, ll, perm, out, G, L, J, C2, tk, tl, stream, true);
}

// Shared memory of one block, in bytes (-1 on error), for a launch whose
// unit covers `span` output rows (L forward, J inverse, tl ragged) and C2
// lanes: the scalar body's static figure as compiled, or the f64
// forward's static plus dynamic; kernels/autotune.py's estimate must
// agree.
long long dwt_dense_smem_bytes(int span, int C2, int itemsize, int inverse) {
  if (itemsize == 4)
    return inverse ? smem_of<float, true>(span, C2) : smem_of<float, false>(span, C2);
  if (inverse) return smem_of<double, true>(span, C2);
  return C2 <= 16 ? smem_dmma<8>() : smem_dmma<32>();
}

}  // extern "C"
