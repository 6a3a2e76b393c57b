// The block body shared by the fused and on-the-fly (dwt_fused.cu) and
// the l-chunked streaming (streaming.cu) DWT / iDWT kernels, and the one
// launcher they all go through (launch_block).
//
// One block owns one cluster k and a slice of CS output lanes.  Thread
// (warp w, lane i) marches the Wigner recurrence (recurrence.cuh) for
// j = 32 w + i, so the two state rows live in registers, and stages the
// rows it generates in shared memory, a round of degrees at a time; warp
// w owns j in [32 w, 32 w + 32).  The body is chosen at compile time by
// the element type.
//
// f64 runs the contraction on the FP64 tensor cores, mma.sync.m16n8k4.
// On the H100 one f64 mma equals the ascending chain acc = fma(a_k, b_k,
// acc) over its k bit for bit, and m16n8k4 / k8 / k16 reach 65-66
// TFLOP/s, m8n8k4 half (PERF.md §6, from a probe of each f64 mma shape).  A
// round is kMT = 16 degrees; the block computes the coefficient triples
// of all its degrees first, and rounds that lie wholly above m march
// without the step's seed and mask selects (march_step, kFastStep).
//  - Forward: out^T[c, t] = sum over the warp's 32 j of rhs^T[c, j]
//    rows[t, j], the mma's m the lane (16 a tile), n the degree (8 a
//    pass), k the j.  The A fragments (rhs) stay in registers for the
//    whole march (CS doubles a thread), and each pass of 8 degrees
//    contracts one m-tile at a time, one accumulator quad a thread (with
//    rhs as the B operand, or with both m-tiles' quads live, the 32-lane
//    slice spilled at its 128 registers).  The warps' partial sums go to
//    a buffer and are added across warps in ascending warp order behind
//    two barriers a round.  The rows are double buffered: warps 4..7 of
//    every 8 march the next round before this round's mma, warps 0..3
//    after it.
//  - Inverse: the warp's g[j, c] for its 32 j is a 32 x CS tile of
//    accumulator quads across the whole march (CS doubles a thread),
//    the degree as the mma's k; each warp marches the next round
//    between the k-steps of this one, and each round's lhs rows are
//    copied in with cp.async one round ahead (one barrier a round).
//  So both sums run in the scalar body's order (the forward ascending
//  over j from 0 within a warp, then across warps; the inverse ascending
//  over degrees), and the f64 kernels give its bits exactly.  The lane
//  slice is 32, or 16 when C2 <= 16.  Past J = 512 the forward runs 1024
//  threads of 64 registers with 8 lanes and reads its A fragments from a
//  copy of the rhs slice in shared memory; the inverse, which has no
//  cross-warp sum, splits j over blocks of 512 threads.
//  What bounds it: the on-the-fly pair does 71 GFLOP at B = 128, V = 8,
//  1.054 ms at the f64 tensor-core rate; the fused and streaming pairs
//  are bound by their operand bytes (0.76-1.05 ms).  Measured
//  (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): on-the-fly 3.147 /
//  3.207 ms (22.4 / 22.0 TFLOP/s), fused 1.768 / 2.029 ms; the
//  recurrence, re-marched by each lane slice, and the cross-warp sum
//  cost about as much as the mma (PERF.md §6).
//
// f32 keeps the scalar body on the FP32 FMA pipes (the FP32 tensor-core
// type, TF32, keeps 10 mantissa bits): 32 lanes, one per thread lane,
// and rounds of kLT = 8 degrees; each warp contracts the staged rows
// against its 32 j-values of the thread's register-resident rhs column,
// and thread (w, i) adds row * lhs into its 32 register accumulators
// g[32 w + jj, c0 + i].
//
// No atomics: a row's result depends only on its row values and
// operands, never on where a degree range starts or how it is grouped
// (padded degrees add fma(0, 0, acc) = acc), so a march cut into chunks
// (resumed from a stored state window) gives the same bits as one march
// over all degrees.
//
// kBf16 rounds each generated row to bfloat16 before the contraction (the
// recurrence state and the sums stay in T).  The rounding goes through
// float, round-to-nearest-even twice (T -> float -> bf16), as torch's
// `.to(torch.bfloat16)` does; `__double2bfloat16` rounds once and would
// differ from the plain version on rare ties.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "recurrence.cuh"

namespace repro {

constexpr int kWarp = 32;
// f32: output lanes per block (one per thread lane), degrees per round
constexpr int kCS = 32;
constexpr int kLT = 8;
// f64: degrees per round, row padding in doubles (strides of 4 mod 16
// doubles make the fragment loads free of bank conflicts), lane slice of
// the 1024-thread forward
constexpr int kMT = 16;
constexpr int kPad = 4;
constexpr int kCS1024 = 8;

__host__ __device__ inline int n_warps(int J) { return (J + kWarp - 1) / kWarp; }

// Row stride of the 512-thread f64 forward's partial sums: 2 mod 8
// doubles, so a fragment's rows (2q apart) fall in distinct bank pairs.
__host__ __device__ constexpr int part_stride(int cs) { return cs + 2; }

template <typename T>
constexpr bool is_f64 = std::is_same_v<T, double>;

// Threads of one block: one per j, in whole warps.  The f64 inverse has no
// cross-warp sum, so past J = 512 it splits the j axis over blocks of 512
// threads (grid z), which keep 128 registers a thread.
template <typename T>
__host__ __device__ inline int block_threads(int J, bool inverse) {
  const int nj = n_warps(J) * kWarp;
  return is_f64<T> && inverse && nj > 512 ? 512 : nj;
}

template <typename T>
__host__ __device__ inline int j_blocks(int J, bool inverse) {
  return (n_warps(J) * kWarp + block_threads<T>(J, inverse) - 1) / block_threads<T>(J, inverse);
}

// Output lanes of one block.
template <typename T>
__host__ __device__ inline int lane_slice(int J, int C2, bool inverse) {
  if constexpr (is_f64<T>) return !inverse && J > 512 ? kCS1024 : (C2 <= 16 ? 16 : 32);
  return kCS;
}

// Dynamic shared memory of one block at (J, L degrees, C2 lanes).  f64:
// kMT staged rows over the block's j (two buffers up to 512 threads), the
// inverse's double-buffered lhs rows, the forward's per-warp partial sums
// or, at 1024 threads, its copy of its rhs slice, and L coefficient
// triples.  f32: kLT staged rows, the forward's per-warp partial sums
// (the inverse's staged lhs rows instead) and kLT triples.
// kernels/autotune.py mirrors it (estimate_smem_bytes).
template <typename T>
__host__ __device__ inline size_t block_smem_bytes(int J, int L, int C2, bool inverse) {
  const int nw = n_warps(J), nj = nw * kWarp;
  if constexpr (is_f64<T>) {
    const int cs = lane_slice<T>(J, C2, inverse), nt = block_threads<T>(J, inverse);
    const size_t rows = size_t(nt <= 512 ? 2 : 1) * kMT * (nt + kPad);
    const size_t other = inverse    ? 2 * kMT * (cs + kPad)
                         : nt > 512 ? size_t(nt) * cs
                                    : size_t(nt / kWarp) * kMT * part_stride(cs);
    return sizeof(T) * (rows + other) + sizeof(WignerCoeffs<T>) * size_t(L);
  }
  return sizeof(T) * (size_t(kLT) * nj + (inverse ? size_t(kLT) * kCS : size_t(nw) * kLT * kCS)) +
         sizeof(WignerCoeffs<T>) * kLT;
}

// First degree this cluster contributes at: its m when the seed row
// activates inside the tile's range (m >= the tile's l0), else L: never
// seeded, all zero, as in the TPU kernel that starts a tile at l0.
__device__ inline int first_degree(int l0, int m, int L) { return m >= l0 ? m : L; }

template <typename T>
__device__ __forceinline__ T round_bf16(T x) {
  return T(__bfloat162float(__float2bfloat16_rn(float(x))));
}

template <typename T, bool kBf16>
__device__ __forceinline__ T row_value(T x) {
  if constexpr (kBf16) return round_bf16(x);
  return x;
}

// Window element (T, or bf16 storage) -> state value.
template <typename T, typename S>
__device__ __forceinline__ T load_state(S w) {
  if constexpr (sizeof(S) == 2) return T(__bfloat162float(w));
  else return T(w);
}

// State value -> window element (rounded once, on store).
template <typename S, typename T>
__device__ __forceinline__ S store_state(T x) {
  if constexpr (sizeof(S) == 2) return __float2bfloat16_rn(float(x));
  else return S(x);
}

// Write zero rows [l_lo, l_hi) of the block's lane slice [c0, c0 + cs).
template <typename T>
__device__ __forceinline__ void zero_rows(T* out_k, int l_lo, int l_hi, int C2, int c0, int cs) {
  for (int idx = threadIdx.x; idx < (l_hi - l_lo) * cs; idx += blockDim.x) {
    const int c = c0 + idx % cs;
    if (c < C2) out_k[size_t(l_lo + idx / cs) * C2 + c] = T(0);
  }
}

// ---------------------------------------------------------------------------
// f32: the scalar FMA body
// ---------------------------------------------------------------------------

template <typename T>
struct FwdSmem {
  T* rows;                // [kLT][nj]
  T* part;                // [nw][kLT][kCS]
  WignerCoeffs<T>* coef;  // [kLT]
  __device__ explicit FwdSmem(unsigned char* smem, int nw) {
    rows = reinterpret_cast<T*>(smem);
    part = rows + kLT * nw * kWarp;
    coef = reinterpret_cast<WignerCoeffs<T>*>(part + nw * kLT * kCS);
  }
};

// This thread's lane of rhs for the warp's 32 j-values (zero past J / C2).
template <typename T>
__device__ __forceinline__ void load_rhs(T (&r)[kWarp], const T* rhs_k, int J, int C2, int c0) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int c = c0 + lane;
#pragma unroll
  for (int i = 0; i < kWarp; ++i) {
    const int jj = w * kWarp + i;
    r[i] = (jj < J && c < C2) ? rhs_k[size_t(jj) * C2 + c] : T(0);
  }
}

// Forward rows l in [lb0, lend): out_k[l, c0:c0+32] = sum_j d_l[j] rhs[j, c].
// (d_prev, d_cur) hold the state at the start of degree lb0.
template <typename T, bool kBf16>
__device__ __forceinline__ void fwd_rows(int lb0, int lend, int m, int mp, T cb, T seed,
                                         T& d_prev, T& d_cur, const T (&r)[kWarp],
                                         const FwdSmem<T>& sm, T* out_k, int C2, int c0) {
  const int nw = blockDim.x / kWarp;
  const int nj = nw * kWarp;
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int j = w * kWarp + lane;
  for (int lb = lb0; lb < lend; lb += kLT) {
    const int nlt = min(kLT, lend - lb);
    if (threadIdx.x < nlt) sm.coef[threadIdx.x] = wigner_coeffs<T>(lb + threadIdx.x, m, mp);
    __syncthreads();
    for (int t = 0; t < nlt; ++t)
      sm.rows[t * nj + j] =
          row_value<T, kBf16>(wigner_step<T>(sm.coef[t], lb + t, m, cb, seed, d_prev, d_cur));
    __syncthreads();
    for (int t = 0; t < nlt; ++t) {
      const T* rw = sm.rows + t * nj + w * kWarp;
      T acc = T(0);
#pragma unroll
      for (int i = 0; i < kWarp; ++i) acc = fma(rw[i], r[i], acc);
      sm.part[(w * kLT + t) * kCS + lane] = acc;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nlt * kCS; idx += blockDim.x) {
      const int t = idx / kCS, cc = idx % kCS;
      T s = T(0);
      for (int ww = 0; ww < nw; ++ww) s += sm.part[(ww * kLT + t) * kCS + cc];
      if (c0 + cc < C2) out_k[size_t(lb + t) * C2 + c0 + cc] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// f64: the DMMA body
// ---------------------------------------------------------------------------

// d += a b over one 16 x 8 x 4 tile.  Fragments (g = lane / 4, q = lane % 4):
// a0 = A[g][q], a1 = A[g + 8][q]; b = B[q][g]; d = C[g][2q], C[g][2q + 1],
// C[g + 8][2q], C[g + 8][2q + 1].
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// 8-byte asynchronous copy global -> shared; n = 0 writes zero.
__device__ __forceinline__ void cp_async8(double* dst, const double* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n"); }

// Coefficient triples of degrees [lbeg, lend), at coef[l - lbeg], computed
// by the whole block before anything else is live (the divisions and
// square roots of wigner_coeffs stay out of the march loops).
__device__ __forceinline__ void compute_coefs(WignerCoeffs<double>* coef, int lbeg, int lend,
                                              int m, int mp) {
  for (int i = threadIdx.x; i < lend - lbeg; i += blockDim.x)
    coef[i] = wigner_coeffs<double>(lbeg + i, m, mp);
  __syncthreads();
}

// A round is fast when it is whole and every degree in it lies above the
// cluster's m: then no step seeds, masks or holds the state.
__device__ __forceinline__ bool fast_round(int lb, int n, int m) { return n == kMT && lb > m; }

// The kinds of round a march step can be in: part of a round (t may pass
// n), a whole round, a fast round.
enum StepKind { kPartStep, kWholeStep, kFastStep };

__device__ __forceinline__ StepKind step_kind(int lb, int n, int m) {
  return fast_round(lb, n, m) ? kFastStep : n == kMT ? kWholeStep : kPartStep;
}

// One step of a round: rows[t][j] = the row of degree lb + t if t < n
// (the state advances), else zero (the state holds).  Branch-free, so
// that it interleaves with the mma of the round before.  In a whole round
// t < n always; in a fast round wigner_step's seed and activity tests are
// constant too, so it is called with (l, m) = (1, 0), which folds them
// away.  The arithmetic, and so every bit of the row and the state, is
// the same in all three.
template <bool kBf16, StepKind kKind>
__device__ __forceinline__ void march_step(double* rows, int S, int j, int lb, int n,
                                           const WignerCoeffs<double>* c, int t, int m,
                                           double cb, double seed, double& d_prev,
                                           double& d_cur) {
  if constexpr (kKind == kFastStep) {
    rows[t * S + j] =
        row_value<double, kBf16>(wigner_step<double>(c[t], 1, 0, cb, seed, d_prev, d_cur));
  } else if constexpr (kKind == kWholeStep) {
    rows[t * S + j] =
        row_value<double, kBf16>(wigner_step<double>(c[t], lb + t, m, cb, seed, d_prev, d_cur));
  } else {
    const bool ok = t < n;
    double dp = d_prev, dc = d_cur;
    const double v = wigner_step<double>(c[ok ? t : 0], lb + t, m, cb, seed, dp, dc);
    d_prev = ok ? dp : d_prev;
    d_cur = ok ? dc : d_cur;
    rows[t * S + j] = ok ? row_value<double, kBf16>(v) : 0.0;
  }
}

// A whole round, kUnroll steps at a time (the coefficient loads of a group
// are issued together; a full unroll would keep all of them live).
template <bool kBf16, int kUnroll = 4>
__device__ __forceinline__ void march_round(double* rows, int S, int j, int lb, int n,
                                            const WignerCoeffs<double>* c, int m, double cb,
                                            double seed, double& d_prev, double& d_cur) {
  const StepKind kind = step_kind(lb, n, m);
  if (kind == kFastStep) {
#pragma unroll kUnroll
    for (int t = 0; t < kMT; ++t)
      march_step<kBf16, kFastStep>(rows, S, j, lb, n, c, t, m, cb, seed, d_prev, d_cur);
  } else if (kind == kWholeStep) {
#pragma unroll kUnroll
    for (int t = 0; t < kMT; ++t)
      march_step<kBf16, kWholeStep>(rows, S, j, lb, n, c, t, m, cb, seed, d_prev, d_cur);
  } else {
#pragma unroll kUnroll
    for (int t = 0; t < kMT; ++t)
      march_step<kBf16, kPartStep>(rows, S, j, lb, n, c, t, m, cb, seed, d_prev, d_cur);
  }
}

// The march of an inverse contraction: none (kMarch false), or the next
// round's steps of kind kKind between its k-steps.
template <bool kMarch, StepKind kKind = kPartStep>
struct MarchMode {
  static constexpr bool march = kMarch;
  static constexpr StepKind kind = kKind;
};

// In the forward, warps 4..7 of every 8 march the next round before this
// round's mma and warps 0..3 after it, so that each SM sub-partition
// (warp w % 4) holds both kinds of work at once.
__device__ __forceinline__ bool march_first() { return (threadIdx.x / kWarp) & 4; }

// The forward's A fragments, rhs[32 w + 4 ks + q][c0 + 16 mt + g (+ 8)]
// (a slice of 8 lanes leaves the upper half of its m-tile zero): held in
// registers for the whole march (fa, CS doubles a thread) by the
// 512-thread instantiations, read from a copy of the block's rhs slice in
// shared memory ([nj][CS]) by the 1024-thread one, which has 64
// registers.
template <int CS>
constexpr int kMTiles = CS < 16 ? 1 : CS / 16;

template <int CS>
__device__ __forceinline__ void load_rhs_frags(double (&fa)[8][kMTiles<CS>][2],
                                               const double* rhs_k, int J, int C2, int c0) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int mt = 0; mt < kMTiles<CS>; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int jj = w * kWarp + 4 * ks + q, cc = 16 * mt + g + 8 * h;
        fa[ks][mt][h] = (jj < J && cc < CS && c0 + cc < C2) ? rhs_k[size_t(jj) * C2 + c0 + cc]
                                                            : 0.0;
      }
}

template <int CS>
__device__ __forceinline__ void stage_rhs(double* rhs_sm, const double* rhs_k, int J, int C2,
                                          int c0) {
  for (int idx = threadIdx.x; idx < int(blockDim.x) * CS; idx += blockDim.x) {
    const int jj = idx / CS, c = c0 + idx % CS;
    rhs_sm[idx] = (jj < J && c < C2) ? rhs_k[size_t(jj) * C2 + c] : 0.0;
  }
}

// Steps the 512-thread forward marches at a time: two (one under kBf16,
// whose rounding through float needs registers of its own).
template <bool kBf16>
constexpr int kUnrollFwd = kBf16 ? 1 : 2;

// Forward rows l in [lb0, lend): out_k[l, c0:c0+CS] = sum_j d_l[j] rhs[j, c].
// (d_prev, d_cur) hold the state at the start of degree lb0.  Shared
// memory: rows [kBuf][kMT][nj + kPad]; then the warps' partial sums
// [nw][kMT][CS + 2] (512 threads) or the rhs copy (1024 threads,
// `other`); then the coefficient triples.  A round is two passes of 8
// degrees, each contracted one m-tile (16 lanes) at a time, so a thread
// holds one accumulator quad; the block adds the warps' partial sums
// behind two barriers a round.  kPipe (J <= 512): the rows are double
// buffered and the next round is marched during this one (march_first).
// The 1024-thread forward (one m-tile) writes its partial sums over the
// rows each pass has just read.
template <int CS, bool kBf16, bool kPipe>
__device__ __forceinline__ void fwd_rows_mma(int lb0, int lend, int m, double cb, double seed,
                                             double d_prev, double d_cur,
                                             const double (&fa)[8][kMTiles<CS>][2],
                                             double* other, const WignerCoeffs<double>* coef,
                                             double* smem, double* out_k, int C2, int c0) {
  constexpr int kNM = kMTiles<CS>;
  constexpr int PS = kPipe ? part_stride(CS) : 0;
  const int nw = blockDim.x / kWarp, S = nw * kWarp + kPad;
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int g = lane >> 2, q = lane & 3;
  double* const rows0 = smem;
  double* const rows1 = smem + (kPipe ? kMT * S : 0);
  const double* const ra = other + (w * kWarp + q) * CS + g;  // the rhs copy (1024 threads)
  const auto a_frag = [&](int ks, int mt, int h) {
    if constexpr (kPipe)
      return fa[ks][mt][h];
    else
      return 16 * mt + 8 * h < CS ? ra[4 * ks * CS + 16 * mt + 8 * h] : 0.0;
  };
  int lb = lb0, n = min(kMT, lend - lb0), buf = 0;
  march_round<kBf16, kPipe ? 2 : 1>(rows0, S, threadIdx.x, lb, n, coef, m, cb, seed, d_prev,
                                    d_cur);
  while (n > 0) {
    const int lbn = lb + kMT, nn = min(kMT, lend - lbn);  // next round (nn <= 0: none)
    const WignerCoeffs<double>* cn = coef + (nn > 0 ? lbn - lb0 : 0);
    double* const cur = buf ? rows1 : rows0;
    double* const nxt = kPipe && !buf ? rows1 : rows0;
    if (kPipe && nn > 0 && march_first())
      march_round<kBf16, kUnrollFwd<kBf16>>(nxt, S, threadIdx.x, lbn, nn, cn, m, cb, seed,
                                            d_prev, d_cur);
    __syncwarp();
    // pass (p, mt): degrees 8p .. 8p + 7 of this round, lanes 16 mt ..
    // 16 mt + 15, k = the warp's 32 j in ascending order
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const double* rb = cur + (8 * p + g) * S + w * kWarp + q;
#pragma unroll
      for (int mt = 0; mt < kNM; ++mt) {
        double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          dmma(acc, a_frag(ks, mt, 0), a_frag(ks, mt, 1), rb[4 * ks]);
        // acc[e] = partial[t = 8p + 2q + (e & 1)][c = 16 mt + g + 8 (e >> 1)]
        if constexpr (kPipe) {
          double* pw = other + (w * kMT + 8 * p + 2 * q) * PS + 16 * mt + g;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (16 * mt + 8 * (e >> 1) < CS) pw[(e & 1) * PS + 8 * (e >> 1)] = acc[e];
        } else {
          __syncwarp();  // every lane has read the pass's rows
          double* pw = cur + (8 * p + 2 * q) * S + w * kWarp + g;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * (e >> 1) < CS) pw[(e & 1) * S + 8 * (e >> 1)] = acc[e];
        }
      }
    }
    if (kPipe && nn > 0 && !march_first())
      march_round<kBf16, kUnrollFwd<kBf16>>(nxt, S, threadIdx.x, lbn, nn, cn, m, cb, seed,
                                            d_prev, d_cur);
    __syncthreads();
    // out[t, c:c+2] = the warps' partials added in ascending warp order
    const double* src = kPipe ? other : cur;
    const int ws = kPipe ? kMT * PS : kWarp, ts = kPipe ? PS : S;
    for (int idx = threadIdx.x; idx < n * (CS / 2); idx += blockDim.x) {
      const int t = idx / (CS / 2), c = 2 * (idx % (CS / 2));
      double2 s = make_double2(0.0, 0.0);
      for (int ww = 0; ww < nw; ++ww) {
        const double2 v = *reinterpret_cast<const double2*>(src + ww * ws + t * ts + c);
        s.x += v.x;
        s.y += v.y;
      }
      double* o = out_k + size_t(lb + t) * C2 + c0 + c;
      if (c0 + c + 1 < C2)
        *reinterpret_cast<double2*>(o) = s;
      else if (c0 + c < C2)
        o[0] = s.x;
    }
    __syncthreads();
    if (!kPipe && nn > 0)
      march_round<kBf16, 1>(rows0, S, threadIdx.x, lbn, nn, cn, m, cb, seed, d_prev, d_cur);
    lb = lbn;
    n = nn;
    buf ^= int(kPipe);
  }
}

// The rounds of an inverse march: the degree ranges
// [max(lbeg, base), min(base + lchunk, lend)) for base = lchunk floor(lbeg /
// lchunk), ... (the streaming kernels' chunks; the fused kernels pass
// lchunk = L, one range), each cut into rounds of kMT from its start.  A
// round with fresh set starts a range: its state is loaded anew.
struct Round {
  int lb, n, lc;
  bool fresh;
};

__device__ __forceinline__ Round first_round(int lbeg, int lend, int lchunk) {
  const int lc = lbeg / lchunk;
  return {lbeg, min(kMT, min((lc + 1) * lchunk, lend) - lbeg), lc, true};
}

__device__ __forceinline__ Round next_round(const Round& r, int lend, int lchunk) {
  const int hi = min((r.lc + 1) * lchunk, lend);
  if (r.lb + kMT < hi) return {r.lb + kMT, min(kMT, hi - r.lb - kMT), r.lc, false};
  const int base = (r.lc + 1) * lchunk;
  return {base, min(kMT, min(base + lchunk, lend) - base), r.lc + 1, true};
}

// The forward body of one block: rows l in [lb0, lend) of the lane slice
// [c0, c0 + CS), from the state (d_prev, d_cur) at degree lb0.  kPipe:
// the 512-thread instantiation (J <= 512), whose f64 rows are double
// buffered.
template <typename T, int CS, bool kBf16, bool kPipe>
__device__ __forceinline__ void fwd_block(int lb0, int lend, int m, int mp, T cb, T seed,
                                          T& d_prev, T& d_cur, const T* rhs_k, T* out_k,
                                          int J, int C2, int c0, unsigned char* smem) {
  if constexpr (is_f64<T>) {
    const int nt = blockDim.x;
    double* const rows = reinterpret_cast<double*>(smem);
    double* const other = rows + (kPipe ? 2 : 1) * kMT * (nt + kPad);
    auto* const coef = reinterpret_cast<WignerCoeffs<double>*>(
        other + (kPipe ? nt / kWarp * kMT * part_stride(CS) : nt * CS));
    if constexpr (!kPipe) stage_rhs<CS>(other, rhs_k, J, C2, c0);
    compute_coefs(coef, lb0, lend, m, mp);  // its barrier publishes the rhs copy
    double fa[8][kMTiles<CS>][2];
    if constexpr (kPipe) load_rhs_frags<CS>(fa, rhs_k, J, C2, c0);
    fwd_rows_mma<CS, kBf16, kPipe>(lb0, lend, m, cb, seed, d_prev, d_cur, fa, other, coef, rows,
                                   out_k, C2, c0);
  } else {
    static_assert(CS == kCS, "the scalar body runs 32-lane slices");
    T r[kWarp];
    load_rhs(r, rhs_k, J, C2, c0);
    const FwdSmem<T> sm(smem, blockDim.x / kWarp);
    fwd_rows<T, kBf16>(lb0, lend, m, mp, cb, seed, d_prev, d_cur, r, sm, out_k, C2, c0);
  }
}

// The inverse body of one block: run() accumulates g[j, c0:c0+CS] over
// the degrees [lbeg, lend), cut into l-chunks of lchunk (the fused
// kernels pass lchunk = L), each chunk marched from the state
// load(lc, d_prev, d_cur) gives; store() writes g.  Primary template: the
// scalar FMA body (f32).
template <typename T, int CS, bool kPipe>
struct InvBody {
  static_assert(CS == kCS, "the scalar body runs 32-lane slices");
  T acc[kWarp];
  T* rows;                // [kLT][nj]
  T* lhs;                 // [kLT][kCS]
  WignerCoeffs<T>* coef;  // [kLT]

  __device__ explicit InvBody(unsigned char* smem) {
    const int nw = blockDim.x / kWarp;
    rows = reinterpret_cast<T*>(smem);
    lhs = rows + kLT * nw * kWarp;
    coef = reinterpret_cast<WignerCoeffs<T>*>(lhs + kLT * kCS);
#pragma unroll
    for (int i = 0; i < kWarp; ++i) acc[i] = T(0);
  }

  template <bool kBf16, typename Load>
  __device__ __forceinline__ void run(int lbeg, int lend, int lchunk, const Load& load, int m,
                                      int mp, T cb, T seed, const T* lhs_k, int C2, int c0) {
    for (int lc = lbeg / lchunk; lc * lchunk < lend; ++lc) {
      const int base = lc * lchunk;
      T d_prev, d_cur;
      load(lc, d_prev, d_cur);
      rows_of<kBf16>(max(lbeg, base), min(base + lchunk, lend), m, mp, cb, seed, d_prev, d_cur,
                     lhs_k, C2, c0);
    }
  }

  // Rows l in [lb0, lend): acc[jj] += d_l[32 w + jj] lhs[l, c0 + lane],
  // ascending l.  (d_prev, d_cur) hold the state at the start of degree
  // lb0.
  template <bool kBf16>
  __device__ __forceinline__ void rows_of(int lb0, int lend, int m, int mp, T cb, T seed,
                                          T& d_prev, T& d_cur, const T* lhs_k, int C2, int c0) {
    const int nw = blockDim.x / kWarp;
    const int nj = nw * kWarp;
    const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
    const int j = w * kWarp + lane;
    for (int lb = lb0; lb < lend; lb += kLT) {
      const int nlt = min(kLT, lend - lb);
      if (threadIdx.x < nlt) coef[threadIdx.x] = wigner_coeffs<T>(lb + threadIdx.x, m, mp);
      for (int idx = threadIdx.x; idx < nlt * kCS; idx += blockDim.x) {
        const int t = idx / kCS, cc = idx % kCS;
        lhs[idx] = c0 + cc < C2 ? lhs_k[size_t(lb + t) * C2 + c0 + cc] : T(0);
      }
      __syncthreads();
      for (int t = 0; t < nlt; ++t)
        rows[t * nj + j] =
            row_value<T, kBf16>(wigner_step<T>(coef[t], lb + t, m, cb, seed, d_prev, d_cur));
      __syncthreads();
      for (int t = 0; t < nlt; ++t) {
        const T* rw = rows + t * nj + w * kWarp;
        const T x = lhs[t * kCS + lane];
#pragma unroll
        for (int i = 0; i < kWarp; ++i) acc[i] = fma(rw[i], x, acc[i]);
      }
      __syncthreads();
    }
  }

  // Store the thread's 32 accumulators into g_k[:, c0 + lane].
  __device__ __forceinline__ void store(T* g_k, int J, int C2, int c0) const {
    const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
    const int c = c0 + lane;
    if (c >= C2) return;
#pragma unroll
    for (int i = 0; i < kWarp; ++i) {
      const int jj = w * kWarp + i;
      if (jj < J) g_k[size_t(jj) * C2 + c] = acc[i];
    }
  }
};

// f64: the DMMA body.  acc[mt][nt] is the C fragment of
// g[32 w + 16 mt + (g, g + 8)][c0 + 8 nt + (2q, 2q + 1)].  Shared memory:
// rows [2][kMT][nj + kPad], lhs [2][kMT][CS + kPad], then the coefficient
// triples.  Each round's lhs rows are copied in with cp.async one round
// ahead, and each warp marches round r + 1 into the other row buffer
// between the mma k-steps of round r.  The rows are warp-private; one
// block barrier a round publishes the staged lhs.
template <int CS, bool kPipe>
struct InvBody<double, CS, kPipe> {
  static_assert(kPipe, "the f64 inverse runs blocks of at most 512 threads (block_threads)");
  double acc[2][CS / 8][4];
  unsigned char* smem;

  __device__ explicit InvBody(unsigned char* smem_) : smem(smem_) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < CS / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0;
  }

  // Copy round r's lhs rows [kMT][CS] into ls (zero past r.n and C2).
  static __device__ __forceinline__ void stage_lhs(double* ls, const Round& r,
                                                   const double* lhs_k, int C2, int c0) {
    for (int idx = threadIdx.x; idx < kMT * CS; idx += blockDim.x) {
      const int t = idx / CS, c = idx % CS;
      const bool ok = t < r.n && c0 + c < C2;
      cp_async8(ls + t * (CS + kPad) + c, ok ? lhs_k + size_t(r.lb + t) * C2 + c0 + c : lhs_k,
                ok ? 8 : 0);
    }
    cp_async_commit();
  }

  template <bool kBf16, typename Load>
  __device__ __forceinline__ void run(int lbeg, int lend, int lchunk, const Load& load, int m,
                                      int mp, double cb, double seed, const double* lhs_k,
                                      int C2, int c0) {
    constexpr int SL = CS + kPad;
    const int S = blockDim.x + kPad;
    const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
    const int g = lane >> 2, q = lane & 3;
    Round r = first_round(lbeg, lend, lchunk);
    if (r.n <= 0) return;
    double* const rows0 = reinterpret_cast<double*>(smem);
    double* const rows1 = rows0 + kMT * S;
    double* const lhs = rows0 + 2 * kMT * S;
    auto* const coef = reinterpret_cast<WignerCoeffs<double>*>(lhs + 2 * kMT * SL);
    compute_coefs(coef, lbeg, lend, m, mp);
    double d_prev, d_cur;
    load(r.lc, d_prev, d_cur);
    stage_lhs(lhs, r, lhs_k, C2, c0);
    march_round<kBf16>(rows0, S, threadIdx.x, r.lb, r.n, coef + (r.lb - lbeg), m, cb, seed,
                       d_prev, d_cur);
    cp_async_wait_all();
    __syncthreads();
    int buf = 0;  // the row and lhs buffers of this round
    while (r.n > 0) {
      const Round nx = next_round(r, lend, lchunk);
      if (nx.n > 0) {
        stage_lhs(lhs + (buf ^ 1) * kMT * SL, nx, lhs_k, C2, c0);
        if (nx.fresh) load(nx.lc, d_prev, d_cur);
      }
      const WignerCoeffs<double>* cn = coef + (nx.n > 0 ? nx.lb - lbeg : 0);
      double* const nxt = buf ? rows0 : rows1;
      const double* ra = (buf ? rows1 : rows0) + w * kWarp + g;
      const double* ls = lhs + buf * kMT * SL + g;
      // this round's mma, the degree as k; with march, four degrees of the
      // next round between k-steps
      const auto contract = [&](auto march) {
#pragma unroll
        for (int ks = 0; ks < kMT / 4; ++ks) {
          if constexpr (decltype(march)::march) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              march_step<kBf16, decltype(march)::kind>(nxt, S, threadIdx.x, nx.lb, nx.n, cn,
                                                       4 * ks + u, m, cb, seed, d_prev, d_cur);
          }
          const int t = 4 * ks + q;
          double a[2][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            a[mt][0] = ra[t * S + 16 * mt];
            a[mt][1] = ra[t * S + 16 * mt + 8];
          }
#pragma unroll
          for (int nt = 0; nt < CS / 8; ++nt) {
            const double b = ls[t * SL + 8 * nt];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) dmma(acc[mt][nt], a[mt][0], a[mt][1], b);
          }
        }
      };
      if (nx.n > 0) {
        const StepKind kind = step_kind(nx.lb, nx.n, m);
        if (kind == kFastStep)
          contract(MarchMode<true, kFastStep>{});
        else if (kind == kWholeStep)
          contract(MarchMode<true, kWholeStep>{});
        else
          contract(MarchMode<true, kPartStep>{});
      } else {
        contract(MarchMode<false>{});
      }
      cp_async_wait_all();
      __syncthreads();
      r = nx;
      buf ^= 1;
    }
  }

  __device__ __forceinline__ void store(double* g_k, int J, int C2, int c0) const {
    const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < CS / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jj = w * kWarp + 16 * mt + g + 8 * (e >> 1);
          const int c = c0 + 8 * nt + 2 * q + (e & 1);
          if (jj < J && c < C2) g_k[size_t(jj) * C2 + c] = acc[mt][nt][e];
        }
  }
};

// Launch a kernel that runs this block body: block_threads() a block,
// one block per (cluster, lane slice[, chunk or j half]), and the body's
// dynamic shared memory for L degrees.
template <typename T, typename... Params, typename... Args>
cudaError_t launch_block(void (*kernel)(Params...), bool inverse, dim3 grid, int J, int L, int C2,
                         cudaStream_t stream, Args... args) {
  if (J <= 0 || J > 1024) return cudaErrorInvalidValue;
  const size_t smem = block_smem_bytes<T>(J, L, C2, inverse);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, dim3(block_threads<T>(J, inverse)), smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace repro
