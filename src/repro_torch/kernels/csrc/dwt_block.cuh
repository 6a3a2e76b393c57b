// The block body shared by the fused and on-the-fly (dwt_fused.cu) and
// the l-chunked streaming (streaming.cu) DWT / iDWT kernels, and the one
// launcher they all go through (launch_block).
//
// One block owns one cluster k and a slice of kCS = 32 output lanes.  It
// has ceil(J / 32) warps; thread (warp w, lane i) marches the Wigner
// recurrence (recurrence.cuh) for j = 32 w + i, so the two state rows live
// in registers.  Every kLT = 8 degrees the block stages the generated rows
// in shared memory, then
//   * forward (fwd_rows): each warp contracts them against its 32 j-values
//     of the thread's register-resident rhs column, and the per-warp
//     partial sums are added across warps in a fixed order;
//   * inverse (inv_rows): thread (w, i) adds row * lhs[l, c0 + i] into its
//     32 register accumulators g[32 w + jj, c0 + i], in ascending l.
// No atomics: a row's result depends only on its row values and operands,
// never on where a degree range starts or how it is grouped, so a march
// cut into chunks (resumed from a stored state window) gives the same bits
// as one march over all degrees.
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

#include "recurrence.cuh"

namespace repro {

constexpr int kWarp = 32;
constexpr int kCS = 32;  // output lanes per block: one per thread lane
constexpr int kLT = 8;   // degrees staged in shared memory per round

__host__ __device__ inline int n_warps(int J) { return (J + kWarp - 1) / kWarp; }

// Dynamic shared memory of one block: kLT staged rows over the padded J,
// the forward's per-warp partial sums (the inverse's staged lhs rows
// instead) and kLT coefficient triples.  kernels/autotune.py mirrors it.
template <typename T>
__host__ __device__ inline size_t fwd_smem_bytes(int J) {
  const int nj = n_warps(J) * kWarp;
  return sizeof(T) * (size_t(kLT) * nj + size_t(n_warps(J)) * kLT * kCS) +
         sizeof(WignerCoeffs<T>) * kLT;
}

template <typename T>
__host__ __device__ inline size_t inv_smem_bytes(int J) {
  const int nj = n_warps(J) * kWarp;
  return sizeof(T) * (size_t(kLT) * nj + size_t(kLT) * kCS) + sizeof(WignerCoeffs<T>) * kLT;
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

// Shared-memory carve-up of one block (dynamic shared memory).
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

template <typename T>
struct InvSmem {
  T* rows;                // [kLT][nj]
  T* lhs;                 // [kLT][kCS]
  WignerCoeffs<T>* coef;  // [kLT]
  __device__ explicit InvSmem(unsigned char* smem, int nw) {
    rows = reinterpret_cast<T*>(smem);
    lhs = rows + kLT * nw * kWarp;
    coef = reinterpret_cast<WignerCoeffs<T>*>(lhs + kLT * kCS);
  }
};

// Write zero rows [l_lo, l_hi) of the block's lane slice of out_k.
template <typename T>
__device__ __forceinline__ void zero_rows(T* out_k, int l_lo, int l_hi, int C2, int c0) {
  const int nw = blockDim.x / kWarp;
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  if (c0 + lane >= C2) return;
  for (int l = l_lo + w; l < l_hi; l += nw) out_k[size_t(l) * C2 + c0 + lane] = T(0);
}

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

// Inverse rows l in [lb0, lend): acc[jj] += d_l[32 w + jj] lhs[l, c0 + lane],
// ascending l.  (d_prev, d_cur) hold the state at the start of degree lb0.
template <typename T, bool kBf16>
__device__ __forceinline__ void inv_rows(int lb0, int lend, int m, int mp, T cb, T seed,
                                         T& d_prev, T& d_cur, T (&acc)[kWarp],
                                         const InvSmem<T>& sm, const T* lhs_k, int C2, int c0) {
  const int nw = blockDim.x / kWarp;
  const int nj = nw * kWarp;
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int j = w * kWarp + lane;
  for (int lb = lb0; lb < lend; lb += kLT) {
    const int nlt = min(kLT, lend - lb);
    if (threadIdx.x < nlt) sm.coef[threadIdx.x] = wigner_coeffs<T>(lb + threadIdx.x, m, mp);
    for (int idx = threadIdx.x; idx < nlt * kCS; idx += blockDim.x) {
      const int t = idx / kCS, cc = idx % kCS;
      sm.lhs[idx] = c0 + cc < C2 ? lhs_k[size_t(lb + t) * C2 + c0 + cc] : T(0);
    }
    __syncthreads();
    for (int t = 0; t < nlt; ++t)
      sm.rows[t * nj + j] =
          row_value<T, kBf16>(wigner_step<T>(sm.coef[t], lb + t, m, cb, seed, d_prev, d_cur));
    __syncthreads();
    for (int t = 0; t < nlt; ++t) {
      const T* rw = sm.rows + t * nj + w * kWarp;
      const T x = sm.lhs[t * kCS + lane];
#pragma unroll
      for (int i = 0; i < kWarp; ++i) acc[i] = fma(rw[i], x, acc[i]);
    }
    __syncthreads();
  }
}

// Store the thread's 32 accumulators into g_k[:, c0 + lane].
template <typename T>
__device__ __forceinline__ void store_acc(const T (&acc)[kWarp], T* g_k, int J, int C2, int c0) {
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int c = c0 + lane;
  if (c >= C2) return;
#pragma unroll
  for (int i = 0; i < kWarp; ++i) {
    const int jj = w * kWarp + i;
    if (jj < J) g_k[size_t(jj) * C2 + c] = acc[i];
  }
}

// Launch a kernel that runs this block body: ceil(J / 32) warps a block
// and the forward's or the inverse's dynamic shared memory.  k512 / k1024
// are the kernel instantiated with __launch_bounds__(512) / (1024): up to
// 512 threads a block may keep 128 registers a thread, so the 32
// register-resident rhs / accumulator values do not spill there.
template <typename T, typename... Params, typename... Args>
cudaError_t launch_block(void (*k512)(Params...), void (*k1024)(Params...), bool inverse,
                         dim3 grid, int J, cudaStream_t stream, Args... args) {
  if (J <= 0 || J > 1024) return cudaErrorInvalidValue;
  const auto kernel = J <= 512 ? k512 : k1024;
  const size_t smem = inverse ? inv_smem_bytes<T>(J) : fwd_smem_bytes<T>(J);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, dim3(n_warps(J) * kWarp), smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace repro
