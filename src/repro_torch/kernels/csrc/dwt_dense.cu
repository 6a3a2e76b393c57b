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
// for bit, and the bodies that compute one function give the same bits.
// The sums are in the input dtype, as the TPU kernels' accumulator.
//
// Which body runs what:
//
//  * f64, all three (dwt_dense_f64, dwt_ragged_f64, idwt_dense_f64): the
//    FP64 tensor cores, mma.sync.m16n8k4 (dense_dmma).  On the H100 one
//    f64 mma is, bit for bit, the ascending chain acc = fma(a_k, b_k, acc)
//    over its k (PERF.md §6, the probe), so walking the contraction index
//    (j forward, l inverse) in ascending k-steps of 4 with one accumulator
//    per output, chained over all of it from +0 (no split-K, no partial
//    sums across warps; zero table and operand past its end, where
//    fma(0, 0, acc) = acc) gives the scalar body's bits.  A block of 256
//    threads owns BR = 128 output rows (l forward, j inverse) by BC = 64
//    lanes of one launch cluster (16 lanes, in 8-lane warp tiles, when
//    C2 <= 16): 4 x 2 warps, each a 32 x 32 warp tile of 2 m-tiles by 4
//    n-tiles, 32 accumulator doubles a thread (two blocks an SM, no local
//    memory).  Each stage of a 3-stage ring in dynamic shared memory holds
//    16 contraction indices: the table chunk and the operand chunk (16
//    rows by BC), copied with 16-byte cp.async (asking L2 to fetch 256 B,
//    the next stages' bytes, at once); one barrier a stage, two stages in
//    flight while the third is contracted; each thread copies from one
//    base pointer a pass.  The table chunk is copied along the table's
//    rows, which are contiguous along j, and kept as it lies: As[l][j]
//    both ways, BR x 16 j forward, 16 l x BR inverse.  The inverse thus
//    reads d^T without a transposed copy: its A fragment (rows g, g + 8
//    of the m-tile, column q) is As[q][j], the forward's B-fragment
//    pattern.  Rows are padded to 4 mod 16 doubles (20, BR + 4, BC + 4),
//    so every fragment load falls in 16 distinct 8-byte banks per
//    half-warp.  What bounds it: at B = 128, f64, V = 8 (K = 8256,
//    C2 = 128) either direction reads the 2.16 GB table and moves 3.24 GB
//    of operand and output once, 1.6 ms at 3.35 TB/s, against 69 GFLOP,
//    1.0 ms at the f64 tensor-core rate: bytes.  The blocks of a cluster
//    are adjacent in the grid (lanes fastest, then rows), so the second
//    lane tile reads the table chunk, and in the inverse the second row
//    tile the lhs chunk, from L2.  Measured (chip_smoke.py, NVIDIA H100
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
//    The 16-byte copies need d, the operand and the output on 16-byte
//    boundaries and even J and C2 (the wrapper checks; the launch refuses
//    anything else).
//
//  * f32 inverse (idwt_dense_f32): the register-blocked body on the FP32
//    FMA pipes (dense_inv_f32; TF32 would keep 10 mantissa bits and lose
//    FP32_ROUNDTRIP_BOUNDS).  A block owns BR = 128 rows of j by BC = 64
//    lanes (16 when C2 <= 16) of one cluster, 16 x BC / 4 threads; thread
//    (ty, tx) keeps an 8 x 4 micro-tile in registers, rows 4 ty + i and
//    64 + 4 ty + i (i < 4), lanes 4 tx .. 4 tx + 3, and per l reads two
//    float4 of the table chunk and one of the lhs chunk for 32 fma; three
//    blocks an SM at 64 lanes (80 registers, no local memory).  The
//    chunks of 16 l come through the same 3-stage cp.async ring, As[l][j]
//    and Bs[l][c] unpadded: every shared-memory access of a warp, copy or
//    read, lies in one row and is contiguous or a broadcast, so no bank
//    is hit twice.  Each output is one fmaf chain over l ascending from
//    +0, the scalar body's.  What bounds it: the bytes (at B = 64, V = 8
//    they take longer than the FMA pipes' 4.4 GFLOP).  The 16-byte copies
//    need J and C2 multiples of 4 and 16-byte boundaries; other shapes
//    (odd B) run the scalar body, with the same bits.
//
//  * f32 forwards (dwt_dense_f32, dwt_ragged_f32): the scalar body on the
//    FMA pipes (dense_kernel).  A block owns an output tile of one
//    cluster: BR = 16 TR rows by BC = 16 TQ lanes, 256 threads, thread
//    (ty, tx) the TR x TQ elements rows ty + 16 i, lanes tx + 16 q.  It
//    walks the contraction axis in rounds of kKC = 16: each round stages
//    the table chunk, always as As[t][r], and the operand chunk Bs[t][c]
//    in shared memory, then every thread adds a(t, r) * b(t, c) into its
//    registers.  What bounds it: two shared-memory reads per four fma at
//    TQ = TR = 4, single-buffered staging, so the pipes and the
//    shared-memory reads, not the bytes.  The blocks of one cluster are
//    adjacent in the grid.  The body also computes the inverse, reading
//    the table chunk along its rows (d^T): the f32 inverse where the
//    16-byte copies do not fit.  It stays exported as the _fma symbols
//    (dwt_dense_f64_fma, dwt_ragged_f64_fma, idwt_dense_f64_fma,
//    idwt_dense_f32_fma): the bit reference of the other bodies on the
//    card, called by no wrapper.
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
// f64: the DMMA body
// ---------------------------------------------------------------------------

using repro::kWarp;

constexpr int kRingThreads = 256;
constexpr int kRingKC = 16;     // contraction indices per ring stage (4 mma k-steps)
constexpr int kStages = 3;      // ring depth
constexpr int kWarpsM = 4;      // warps along the output rows
constexpr int kWarpsN = 2;      // warps along the lanes
constexpr int kWarpRows = 32;   // output rows of a warp tile (2 m-tiles)
constexpr int kRingBR = kWarpsM * kWarpRows;  // 128 output rows of a block
constexpr int kRingPad = 4;     // row pad: strides = 4 mod 16 doubles

// WN lanes a warp (WN / 8 n-tiles), BC = 2 WN lanes a block.  kTrans: the
// inverse, whose table chunk is 16 rows of l by BR j (the forward's: BR
// rows of l by 16 j); both are kept as they lie in d, As[l][j].
template <int WN, bool kTrans>
struct Ring {
  static constexpr int BC = kWarpsN * WN;
  static constexpr int NT = WN / 8;
  static constexpr int kARows = kTrans ? kRingKC : kRingBR;  // table chunk rows
  static constexpr int SA = (kTrans ? kRingBR : kRingKC) + kRingPad;  // ... and their stride
  static constexpr int SB = BC + kRingPad;  // operand chunk row stride
  // As offsets of one output row and of one contraction index
  static constexpr int RS = kTrans ? 1 : SA;
  static constexpr int KS = kTrans ? SA : 1;
  static constexpr int kAElems = kARows * SA;
  static constexpr int kStage = kAElems + kRingKC * SB;
  static constexpr size_t kSmem = size_t(kStages) * kStage * sizeof(double);
  // 16-byte copies: kARow threads copy a table chunk row, a pass of the
  // block kAPass rows (forward: 32, one warp tile's; inverse: 4 of 16 l);
  // kBRows operand rows a pass
  static constexpr int kARow = (SA - kRingPad) / 2;
  static constexpr int kAPass = kRingThreads / kARow;
  static constexpr int kAPasses = kARows / kAPass;
  static constexpr int kBRows = kRingThreads / (BC / 2);
  static constexpr int kBPasses = kBRows >= kRingKC ? 1 : kRingKC / kBRows;
  static_assert(SA % 16 == 4 && SB % 16 == 4, "fragment loads must be conflict-free");
  static_assert(kTrans || kAPass == kWarpRows, "a forward table pass is one warp tile's rows");
  static_assert(kAPasses * kAPass == kARows, "the passes cover the table chunk");
};

// 16-byte copy global -> shared, with a 256-byte L2 prefetch; ok = false
// writes zeros and reads nothing.
__device__ __forceinline__ void ring_copy(void* dst, const void* src, bool ok) {
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

// y (K, nrows, C2) from the table d (K, L, J) and x (K, ncon, C2): the
// forward (nrows = L, ncon = J; ragged over the work list) or, kTrans,
// the inverse (nrows = J, ncon = L).
template <int WN, bool kTrans, bool kRagged>
__global__ void __launch_bounds__(kRingThreads, 2)
dense_dmma(const double* __restrict__ d, const double* __restrict__ x, const int* __restrict__ kk,
           const int* __restrict__ ll, const int* __restrict__ perm, double* __restrict__ y, int G,
           int nrows, int ncon, int J, int C2, int tk, int tl) {
  static_assert(!(kTrans && kRagged), "the ragged schedule is a forward");
  using R = Ring<WN, kTrans>;
  extern __shared__ __align__(16) double ring[];

  const int nC = (C2 + R::BC - 1) / R::BC;
  const int nR = (nrows + kRingBR - 1) / kRingBR;
  long long bid = blockIdx.x;
  const int ct = int(bid % nC);
  bid /= nC;
  const int rt = int(bid % nR);
  const int unit = int(bid / nR);

  int kl = unit, rbeg = 0, rend = nrows;
  if constexpr (kRagged) {
    const int g = unit / tk;
    const int kt = kk[g], lt = ll[g];
    if (g > 0 && kk[g - 1] == kt && ll[g - 1] + 1 == lt) return;  // inside a run
    kl = kt * tk + unit % tk;
    rbeg = lt * tl;
    rend = min((lt + run_length(kk, ll, g, G, kt, lt)) * tl, nrows);
  }
  const int r0 = rbeg + rt * kRingBR;
  if (r0 >= rend) return;
  const int row = perm ? perm[kl] : kl;
  const int c0 = ct * R::BC;
  // warp tiles (of 32 rows) with a row to store; the others skip their
  // mma, and in the forward no thread copies their table rows
  const int live = min((rend - r0 + kWarpRows - 1) / kWarpRows, kWarpsM);

  // This thread's 16-byte copies for the stage at contraction index t0:
  // table chunk row au + kAPass p (pass p), columns av, av + 1 -- forward:
  // l = r0 + au + 32 p, j = t0 + av; inverse: l = t0 + au + 4 p,
  // j = r0 + av -- and operand rows t0 + bj + kBRows p at lanes c0 + bc.
  // Zero past rend, ncon and C2 (J and C2 are even: a pair never
  // straddles an edge).
  const int au = threadIdx.x / R::kARow, av = 2 * (threadIdx.x % R::kARow);
  const int bj = threadIdx.x / (R::BC / 2), bc = 2 * (threadIdx.x % (R::BC / 2));
  const double* a_src = d + (size_t(row) * (kTrans ? ncon : nrows) + au) * J + av +
                        (kTrans ? r0 : size_t(r0) * J);
  const double* b_src = x + (size_t(row) * ncon + bj) * C2 + c0 + bc;
  const bool b_lane = c0 + bc < C2;
  auto load = [&](int s, int t0) {
    double* as = ring + s * R::kStage + au * R::SA + av;
    double* bs = ring + s * R::kStage + R::kAElems + bj * R::SB + bc;
#pragma unroll
    for (int p = 0; p < R::kAPasses; ++p) {
      const int u = au + R::kAPass * p;  // the table chunk row
      if constexpr (kTrans) {
        const bool ok = t0 + u < ncon && r0 + av < rend;
        ring_copy(as + R::kAPass * p * R::SA,
                  ok ? a_src + size_t(t0 + R::kAPass * p) * J : d, ok);
      } else if (p < live) {
        const bool ok = r0 + u < rend && t0 + av < ncon;
        ring_copy(as + R::kAPass * p * R::SA,
                  ok ? a_src + size_t(R::kAPass * p) * J + t0 : d, ok);
      }
    }
#pragma unroll
    for (int p = 0; p < R::kBPasses; ++p)
      if (bj < kRingKC) {
        const bool ok = b_lane && t0 + bj + R::kBRows * p < ncon;
        ring_copy(bs + R::kBRows * p * R::SB, ok ? b_src + size_t(t0 + R::kBRows * p) * C2 : x,
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

  const int nk = (ncon + kRingKC - 1) / kRingKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kRingKC);
    ring_commit();
  }
  // fragments: A (row g / g + 8 of an m-tile, contraction index q), B
  // (contraction index q, lane g of an n-tile)
  const double* a_frag = ring + (wm * kWarpRows + g) * R::RS + q * R::KS;
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
          a[mi][0] = a_frag[st + (16 * mi) * R::RS + 4 * ks * R::KS];
          a[mi][1] = a_frag[st + (16 * mi + 8) * R::RS + 4 * ks * R::KS];
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
  double* yk = y + (size_t(row) * nrows + wr) * C2 + wc + 2 * q;
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
// f32 inverse: the register-blocked body
// ---------------------------------------------------------------------------

constexpr int kF32BR = 128;  // j rows of a block
constexpr int kF32TY = 16;   // row threads: rows 4 ty + i and 64 + 4 ty + i, i < 4

// BC lanes a block, 4 a thread.  As[l][j] (16 x BR) and Bs[l][c] (16 x BC)
// a stage, unpadded.
template <int BC>
struct F32Ring {
  static constexpr int TX = BC / 4;  // lane threads
  static constexpr int kThreads = kF32TY * TX;
  static constexpr int kAElems = kRingKC * kF32BR;
  static constexpr int kStage = kAElems + kRingKC * BC;
  static constexpr size_t kSmem = size_t(kStages) * kStage * sizeof(float);
  static constexpr int kAQuads = kAElems / 4;        // 16-byte copies of a stage's table chunk
  static constexpr int kBQuads = kRingKC * BC / 4;   // ... and of its lhs chunk
  static_assert(kAQuads % kThreads == 0 && kBQuads % kThreads == 0, "whole copy passes");
};

// g (K, J, C2) = d^T lhs, lhs (K, L, C2): every output one fmaf chain over
// l ascending from +0.  J and C2 are multiples of 4.
template <int BC>
__global__ void __launch_bounds__(F32Ring<BC>::kThreads, 3)
dense_inv_f32(const float* __restrict__ d, const float* __restrict__ x, float* __restrict__ y,
              int L, int J, int C2) {
  using R = F32Ring<BC>;
  extern __shared__ __align__(16) float fring[];

  const int nC = (C2 + BC - 1) / BC;
  const int nR = (J + kF32BR - 1) / kF32BR;
  long long bid = blockIdx.x;
  const int ct = int(bid % nC);
  bid /= nC;
  const int rt = int(bid % nR);
  const int row = int(bid / nR);
  const int r0 = rt * kF32BR, c0 = ct * BC;
  const float* dk = d + size_t(row) * L * J;
  const float* xk = x + size_t(row) * L * C2;

  // 16-byte copy i of a stage: table chunk row i / (BR / 4) at j quad
  // i % (BR / 4), lhs chunk row i / TX at lane quad i % TX; zero past L, J
  // and C2
  auto load = [&](int s, int t0) {
    float* as = fring + s * R::kStage;
    float* bs = as + R::kAElems;
#pragma unroll
    for (int p = 0; p < R::kAQuads / R::kThreads; ++p) {
      const int i = threadIdx.x + R::kThreads * p;
      const int t = i / (kF32BR / 4), j = r0 + 4 * (i % (kF32BR / 4));
      const bool ok = t0 + t < L && j < J;
      ring_copy(as + 4 * i, ok ? dk + size_t(t0 + t) * J + j : d, ok);
    }
#pragma unroll
    for (int p = 0; p < R::kBQuads / R::kThreads; ++p) {
      const int i = threadIdx.x + R::kThreads * p;
      const int t = i / R::TX, c = c0 + 4 * (i % R::TX);
      const bool ok = t0 + t < L && c < C2;
      ring_copy(bs + 4 * i, ok ? xk + size_t(t0 + t) * C2 + c : x, ok);
    }
  };

  const int tx = threadIdx.x % R::TX, ty = threadIdx.x / R::TX;
  float acc[2][4][4];  // [half][row i][lane q]: row r0 + 64 half + 4 ty + i
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[h][i][q] = 0.f;

  const int nk = (L + kRingKC - 1) / kRingKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s * kRingKC);
    ring_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    ring_wait<kStages - 2>();
    __syncthreads();
    if (kc + kStages - 1 < nk) load((kc + kStages - 1) % kStages, (kc + kStages - 1) * kRingKC);
    ring_commit();
    const float* as = fring + (kc % kStages) * R::kStage + 4 * ty;
    const float* bs = fring + (kc % kStages) * R::kStage + R::kAElems + 4 * tx;
#pragma unroll
    for (int t = 0; t < kRingKC; ++t) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + t * kF32BR);
      const float4 a1 = *reinterpret_cast<const float4*>(as + t * kF32BR + kF32BR / 2);
      const float4 b4 = *reinterpret_cast<const float4*>(bs + t * BC);
      const float a[2][4] = {{a0.x, a0.y, a0.z, a0.w}, {a1.x, a1.y, a1.z, a1.w}};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[h][i][q] = fmaf(a[h][i], b[q], acc[h][i][q]);
    }
  }
  ring_wait<0>();

  const int c = c0 + 4 * tx;
  if (c >= C2) return;
  float* yk = y + size_t(row) * J * C2 + c;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = r0 + kF32BR / 2 * h + 4 * ty + i;
      if (j < J)
        *reinterpret_cast<float4*>(yk + size_t(j) * C2) =
            make_float4(acc[h][i][0], acc[h][i][1], acc[h][i][2], acc[h][i][3]);
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

// The scalar body's block tile follows the rows one unit covers and the
// lane count: 16 rows (lanes) per block when there are no more, else 64.
// The fma chain of an element does not depend on the choice.
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

// A ring body's grid check and its dynamic shared memory allowance.
template <typename Kern>
cudaError_t prepare_ring(Kern kern, long long blocks, size_t smem) {
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int WN, bool kTrans, bool kRagged>
cudaError_t launch_dmma(const Args& a) {
  using R = Ring<WN, kTrans>;
  const auto kern = dense_dmma<WN, kTrans, kRagged>;
  const long long blocks = (long long)a.units * ((a.nrows + kRingBR - 1) / kRingBR) *
                           ((a.C2 + R::BC - 1) / R::BC);
  if (blocks == 0) return cudaSuccess;
  const cudaError_t err = prepare_ring(kern, blocks, R::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<unsigned(blocks), kRingThreads, R::kSmem, a.stream>>>(
      static_cast<const double*>(a.d), static_cast<const double*>(a.x), a.kk, a.ll, a.perm,
      static_cast<double*>(a.y), a.units / a.tk, a.nrows, a.ncon, a.J, a.C2, a.tk, a.tl);
  return cudaGetLastError();
}

bool aligned16(const Args& a) {
  return (uintptr_t(a.d) | uintptr_t(a.x) | uintptr_t(a.y)) % 16 == 0;
}

// The lane tile follows C2: 64 lanes (two blocks per cluster at V = 8,
// adjacent in the grid, so the second reads the table chunk from L2), or
// 16 for one transform.  The fma chain of an element does not depend on
// the choice.
template <bool kTrans, bool kRagged>
cudaError_t pick_dmma(const Args& a) {
  if (!aligned16(a) || a.J % 2 || a.C2 % 2) return cudaErrorInvalidValue;
  if (a.C2 <= 16) return launch_dmma<8, kTrans, kRagged>(a);
  return launch_dmma<32, kTrans, kRagged>(a);
}

template <int BC>
cudaError_t launch_inv_f32(const Args& a) {
  using R = F32Ring<BC>;
  const auto kern = dense_inv_f32<BC>;
  const long long blocks = (long long)a.units * ((a.J + kF32BR - 1) / kF32BR) *
                           ((a.C2 + BC - 1) / BC);
  if (blocks == 0) return cudaSuccess;
  const cudaError_t err = prepare_ring(kern, blocks, R::kSmem);
  if (err != cudaSuccess) return err;
  kern<<<unsigned(blocks), R::kThreads, R::kSmem, a.stream>>>(
      static_cast<const float*>(a.d), static_cast<const float*>(a.x), static_cast<float*>(a.y),
      a.ncon, a.J, a.C2);
  return cudaGetLastError();
}

// 64 lanes a block, or 16 for one transform; the scalar body where the
// 16-byte copies do not fit the shape (J or C2 not a multiple of 4, or an
// operand off a 16-byte boundary).  Every body gives the same bits.
cudaError_t pick_inv_f32(const Args& a) {
  if (!aligned16(a) || a.J % 4 || a.C2 % 4) return pick<float, true, false>(a);
  if (a.C2 <= 16) return launch_inv_f32<16>(a);
  return launch_inv_f32<64>(a);
}

template <typename Kern>
long long static_smem(Kern kern) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, kern) == cudaSuccess ? (long long)attr.sharedSizeBytes : -1;
}

template <typename Kern>
long long plus_static(Kern kern, size_t dynamic) {
  const long long st = static_smem(kern);
  return st < 0 ? -1 : st + (long long)dynamic;
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

// The DMMA body's: static as compiled plus the ring's dynamic bytes.
template <bool kTrans>
long long smem_dmma(int C2) {
  return C2 <= 16 ? plus_static(dense_dmma<8, kTrans, false>, Ring<8, kTrans>::kSmem)
                  : plus_static(dense_dmma<32, kTrans, false>, Ring<32, kTrans>::kSmem);
}

bool bad(int K, int L, int J, int C2) { return K <= 0 || L <= 0 || J <= 0 || C2 <= 0; }

// fma = true takes the scalar body (the bit reference of the check
// symbols).
template <typename T>
int dense(bool inverse, const void* d, const void* x, void* y, int K, int L, int J, int C2,
          void* stream, bool fma = false) {
  if (bad(K, L, J, C2)) return int(cudaErrorInvalidValue);
  Args a{d, x, nullptr, nullptr, nullptr, y, K, inverse ? J : L, inverse ? L : J, J, C2, 1, 1,
         static_cast<cudaStream_t>(stream)};
  if (fma) return int(inverse ? pick<T, true, false>(a) : pick<T, false, false>(a));
  if constexpr (sizeof(T) == 8)
    return int(inverse ? pick_dmma<true, false>(a) : pick_dmma<false, false>(a));
  else
    return int(inverse ? pick_inv_f32(a) : pick<T, false, false>(a));
}

template <typename T>
int ragged(const void* d, const void* rhs, const void* kk, const void* ll, const void* perm,
           void* out, int G, int L, int J, int C2, int tk, int tl, void* stream,
           bool fma = false) {
  if (bad(G, L, J, C2) || tk <= 0 || tl <= 0) return int(cudaErrorInvalidValue);
  Args a{d, rhs, static_cast<const int*>(kk), static_cast<const int*>(ll),
         static_cast<const int*>(perm), out, G * tk, L, J, J, C2, tk, tl,
         static_cast<cudaStream_t>(stream)};
  if constexpr (sizeof(T) == 8)
    if (!fma) return int(pick_dmma<false, true>(a));
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

// The scalar FMA body: the other bodies' bit reference on the card.  No
// wrapper calls these.
int dwt_dense_f64_fma(const void* d, const void* rhs, void* out, int K, int L, int J, int C2,
                      void* stream) {
  return dense<double>(false, d, rhs, out, K, L, J, C2, stream, true);
}

int dwt_ragged_f64_fma(const void* d, const void* rhs, const void* kk, const void* ll,
                       const void* perm, void* out, int G, int L, int J, int C2, int tk, int tl,
                       void* stream) {
  return ragged<double>(d, rhs, kk, ll, perm, out, G, L, J, C2, tk, tl, stream, true);
}

int idwt_dense_f64_fma(const void* d, const void* lhs, void* g, int K, int L, int J, int C2,
                       void* stream) {
  return dense<double>(true, d, lhs, g, K, L, J, C2, stream, true);
}

int idwt_dense_f32_fma(const void* d, const void* lhs, void* g, int K, int L, int J, int C2,
                       void* stream) {
  return dense<float>(true, d, lhs, g, K, L, J, C2, stream, true);
}

// Shared memory of one block, in bytes (-1 on error), for a launch whose
// unit covers `span` output rows (L forward, J inverse, tl ragged) and C2
// lanes: the DMMA body's static plus dynamic figure (f64), the f32
// inverse's likewise, or the scalar body's static figure as compiled (the
// f32 forwards); kernels/autotune.py's estimate must agree.
long long dwt_dense_smem_bytes(int span, int C2, int itemsize, int inverse) {
  if (itemsize == 8) return inverse ? smem_dmma<true>(C2) : smem_dmma<false>(C2);
  if (!inverse) return smem_of<float, false>(span, C2);
  return C2 <= 16 ? plus_static(dense_inv_f32<16>, F32Ring<16>::kSmem)
                  : plus_static(dense_inv_f32<64>, F32Ring<64>::kSmem);
}

}  // extern "C"
