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
// One body computes all three.  A block owns an output tile of one
// cluster: BR = 16 TR rows (l forward, j inverse) by BC = 16 TQ lanes,
// 256 threads, thread (ty, tx) the TR x TQ elements rows ty + 16 i, lanes
// tx + 16 q.  It walks the contraction axis (j forward, l inverse) in
// rounds of kKC = 16: each round stages the table chunk, always as
// As[t][r], and the operand chunk Bs[t][c] in shared memory, then every
// thread adds a(t, r) * b(t, c) into its registers.  The inverse reads the
// table chunk along its rows (coalesced) and so gets d^T without a
// transposed copy in device memory.  Each output element is ONE fma chain
// over the contraction index in ascending order, whatever the tile, the
// round or C2: lane k of a V-lane launch equals the single transform bit
// for bit.  The sums are in the input dtype (f64 for f64, f32 for f32), as
// the TPU kernels' accumulator.
//
// What bounds it.  At B = 128, f64, V = 8 (K = 8256, C2 = 128) the table
// is 2.16 GB and the operands 2.16 + 1.08 GB: 5.4 GB of traffic, 1.6 ms
// at 3.35 TB/s, against 69 GFLOP, 1.0 ms at the f64 tensor-core rate.
// This kernel runs on the FP64 FMA pipes (half that rate), with two
// shared-memory reads per four fma at TQ = TR = 4, so it is bound by the
// pipes and the shared-memory reads, not by the bytes.  The blocks of one
// cluster are adjacent in the grid (lanes fastest, then rows), so a table
// row read by the second lane tile comes from L2.  Tensor cores (DMMA,
// mma.sync f64) and TMA are left for a later redesign.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

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

// Static shared memory of the variant a launch with this span and C2
// takes, as the compiled kernel reports it.
template <typename T>
long long smem_of(int span, int C2) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (span <= kTY)
    err = C2 <= kTX ? cudaFuncGetAttributes(&attr, dense_kernel<T, 1, 1, false, false>)
                    : cudaFuncGetAttributes(&attr, dense_kernel<T, 1, 4, false, false>);
  else
    err = C2 <= kTX ? cudaFuncGetAttributes(&attr, dense_kernel<T, 4, 1, false, false>)
                    : cudaFuncGetAttributes(&attr, dense_kernel<T, 4, 4, false, false>);
  return err == cudaSuccess ? (long long)attr.sharedSizeBytes : -1;
}

bool bad(int K, int L, int J, int C2) { return K <= 0 || L <= 0 || J <= 0 || C2 <= 0; }

template <typename T>
int dense(bool inverse, const void* d, const void* x, void* y, int K, int L, int J, int C2,
          void* stream) {
  if (bad(K, L, J, C2)) return int(cudaErrorInvalidValue);
  Args a{d, x, nullptr, nullptr, nullptr, y, K, inverse ? J : L, inverse ? L : J, J, C2, 1, 1,
         static_cast<cudaStream_t>(stream)};
  return int(inverse ? pick<T, true, false>(a) : pick<T, false, false>(a));
}

template <typename T>
int ragged(const void* d, const void* rhs, const void* kk, const void* ll, const void* perm,
           void* out, int G, int L, int J, int C2, int tk, int tl, void* stream) {
  if (bad(G, L, J, C2) || tk <= 0 || tl <= 0) return int(cudaErrorInvalidValue);
  Args a{d, rhs, static_cast<const int*>(kk), static_cast<const int*>(ll),
         static_cast<const int*>(perm), out, G * tk, L, J, J, C2, tk, tl,
         static_cast<cudaStream_t>(stream)};
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

// Shared memory of one block, in bytes, as compiled (-1 on error), for a
// launch whose unit covers `span` output rows (L forward, J inverse, tl
// ragged) and C2 lanes; kernels/autotune.py's estimate must agree.
long long dwt_dense_smem_bytes(int span, int C2, int itemsize) {
  return itemsize == 4 ? smem_of<float>(span, C2) : smem_of<double>(span, C2);
}

}  // extern "C"
