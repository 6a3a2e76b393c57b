// Fused ragged + on-the-fly clustered DWT / iDWT for Hopper (sm_90a), and
// the on-the-fly DWT / iDWT over every degree.
//
// Replaces the Pallas TPU kernels `dwt_fused` (_fused_fwd_kernel) and
// `idwt_fused` (_fused_inv_kernel) of repro/kernels/dwt_fused.py:
//
//   forward:  out[k, l, c] = sum_j d_l[k, j] rhs[k, j, c]   for l >= l0
//   inverse:  g[k, j, c]   = sum_{l >= l0} d_l[k, j] lhs[k, l, c]
//
// where d_l[k, :] is the Wigner-d row of cluster k at degree l, generated
// in place by the three-term recurrence (recurrence.cuh) from a seed row:
// the (K, L, J) table never exists in device memory.  l0 = l0s[k / tk] is
// the cluster tile's first degree; rows below it are zero.
//
// Layout (row-major, contiguous): seeds (K, J), m, mp (K,) int32,
// cos_beta (J,), rhs (K, J, C2), lhs / out (K, L, C2), g (K, J, C2),
// l0s (K / tk,) int32, with J = 2B, L = B and C2 = V * 16 lanes.  Block k
// (clusters in the l-start-sorted launch order of seeds, m, mp and l0s)
// reads and writes operand row perm[k] (perm (K,) int32, or null for the
// identity), so the caller's (K, ., C2) stacks are never copied into the
// launch order and back.
//
// What bounds it.  Per visited row the contraction is 2 J C2 operations
// against J C2 + L C2 bytes of operands over the whole l-loop, so at
// B = 128, V = 8, f64 the card's floor is the memory term (rhs + out +
// seeds ~ 3.3 GB at 3.35 TB/s ~ 1 ms); the operation term (~23 GFLOP at
// the f64 tensor-core rate, ~0.35 ms) is smaller.  Measured (chip_smoke.py
// phase 3, NVIDIA H100 80GB HBM3, 700.00 W): 1.768 / 2.029 ms, 1.81 /
// 2.67x the byte bound, against torch.bmm's 1.784 / 1.948 ms on the
// materialized table.
//
// Design (the block body is dwt_block.cuh, shared with streaming.cu).
// The TPU kernel keeps a (TK, J, C2) rhs tile and a (TK, L, C2) output
// tile in VMEM; at B = 128, f64, V = 8 the rhs tile alone is 2 MiB and a
// block has 227 KB of shared memory.  Here one block owns ONE cluster and
// a slice of 32 lanes (16 when C2 <= 16):
//   * thread (warp w, lane i) marches the recurrence for j = 32 w + i, so
//     the two state rows live in registers; the generated rows are staged
//     16 degrees at a time in shared memory;
//   * f64 contracts them on the FP64 tensor cores (mma.sync m16n8k4, an
//     ascending fma chain over its k): the forward holds the lane slice's
//     rhs for the warp's 32 j as mma fragments in registers (rhs is read
//     once) and adds the warps' partial sums in a fixed order; the
//     inverse holds g[32 w .. 32 w + 31, slice] as accumulator fragments
//     across the whole l-loop and adds each round with the degree as the
//     mma's k; f32 keeps the scalar FMA body;
//   * no atomics: the sums run in the same order whatever the degree range
//     and V, so the results are deterministic, the on-the-fly and
//     streaming kernels equal these bit for bit, and the f64 kernels give
//     the scalar body's bits;
//   * a block starts at its own cluster's m instead of the tile's l0: rows
//     l0 <= l < m are zero by the recurrence's active mask, so the output
//     is the same, and the forward writes those zero rows itself.
// Each lane slice recomputes its cluster's recurrence (C2 / 32 times per
// cluster, 4x at V = 8); past J = 512 the forward runs 1024 threads with
// 8-lane slices and the inverse splits j over blocks of 512 threads.
//
// The on-the-fly kernels (kEvery) replace `dwt_onthefly` (_fwd_kernel) and
// `idwt_onthefly` (_inv_kernel) of repro/kernels/wigner_rec.py: the same
// kernels with clusters in the plan's order (no perm, no tile l-starts)
// and every block marching EVERY degree from l = 0.  Rows below the
// cluster's m are zero by the recurrence's active mask, not skipped.  This
// is the no-skip baseline the reference's autotuner and benchmarks compare
// the fused schedule against, so it must not take the first-degree
// shortcut.  Its outputs equal the fused kernels' by value: from l = m on
// both run the same state through the same block body, and a row's sums do
// not depend on where the march started.  It generates and contracts
// every row, K L (2 J C2 + 5 J) operations (71 GFLOP at B = 128, f64,
// V = 8), about three times the fused kernels' ragged rows, against the
// same operand bytes: its floor is the operation term at the f64
// tensor-core rate, 1.054 ms.  Measured (chip_smoke.py phase 3d, NVIDIA
// H100 80GB HBM3, 700.00 W): 3.147 / 3.207 ms, 22.4 / 22.0 TFLOP/s,
// 1.78 / 1.65x torch.bmm on the table.
#include <cuda_runtime.h>

#include <cstdint>

#include "dwt_block.cuh"

namespace {

using namespace repro;

// kEvery: the on-the-fly kernels (every degree from l = 0; l0s unused).
// kCSl: the block's lane slice (lane_slice in dwt_block.cuh).
template <typename T, int kMaxThreads, bool kEvery, int kCSl>
__global__ void __launch_bounds__(kMaxThreads, 1)
dwt_fused_fwd(const T* __restrict__ seeds, const int* __restrict__ m_arr,
              const int* __restrict__ mp_arr, const T* __restrict__ cos_beta,
              const T* __restrict__ rhs, const int* __restrict__ l0s,
              const int* __restrict__ perm, T* __restrict__ out, int J, int L,
              int C2, int tk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = blockIdx.x;
  const int row = perm ? perm[k] : k;
  const int c0 = blockIdx.y * kCSl;
  const int j = threadIdx.x;
  const int m = m_arr[k], mp = mp_arr[k];
  const int lbeg = kEvery ? 0 : first_degree(l0s[k / tk], m, L);

  T* out_k = out + size_t(row) * L * C2;
  zero_rows(out_k, 0, lbeg, C2, c0, kCSl);
  if (lbeg >= L) return;

  const T seed = j < J ? seeds[size_t(k) * J + j] : T(0);
  const T cb = j < J ? cos_beta[j] : T(0);
  T d_prev = T(0), d_cur = T(0);
  fwd_block<T, kCSl, false, (kMaxThreads <= 512)>(lbeg, L, m, mp, cb, seed, d_prev, d_cur,
                                                rhs + size_t(row) * J * C2, out_k, J, C2, c0,
                                                smem);
}

template <typename T, int kMaxThreads, bool kEvery, int kCSl>
__global__ void __launch_bounds__(kMaxThreads, 1)
dwt_fused_inv(const T* __restrict__ seeds, const int* __restrict__ m_arr,
              const int* __restrict__ mp_arr, const T* __restrict__ cos_beta,
              const T* __restrict__ lhs, const int* __restrict__ l0s,
              const int* __restrict__ perm, T* __restrict__ g, int J, int L,
              int C2, int tk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = blockIdx.x;
  const int row = perm ? perm[k] : k;
  const int c0 = blockIdx.y * kCSl;
  const int j0 = blockIdx.z * blockDim.x;  // the block's j half (f64 past J = 512)
  const int j = j0 + threadIdx.x;
  const int m = m_arr[k], mp = mp_arr[k];
  const int lbeg = kEvery ? 0 : first_degree(l0s[k / tk], m, L);

  InvBody<T, kCSl, (kMaxThreads <= 512)> body(smem);
  const T seed = j < J ? seeds[size_t(k) * J + j] : T(0);
  const T cb = j < J ? cos_beta[j] : T(0);
  const T* lhs_k = lhs + size_t(row) * L * C2;
  if constexpr (is_f64<T>) {
    const auto zero_state = [](int, T& d_prev, T& d_cur) { d_prev = d_cur = T(0); };
    body.template run<false>(lbeg, L, L, zero_state, m, mp, cb, seed, lhs_k, C2, c0);
  } else {  // one range from a zero state, as the scalar body always ran
    T d_prev = T(0), d_cur = T(0);
    body.template rows_of<false>(lbeg, L, m, mp, cb, seed, d_prev, d_cur, lhs_k, C2, c0);
  }
  body.store(g + (size_t(row) * J + j0) * C2, J - j0, C2, c0);
}

// The instantiation a launch runs: up to 512 threads a block may keep
// 128 registers a thread, 1024 threads 64.  Only the (threads, lane
// slice) pairs that block_threads() and lane_slice() pick are
// instantiated.
template <typename T, bool kEvery>
auto pick_kernel(bool inverse, int J, int C2) {
  if constexpr (is_f64<T>) {
    const bool narrow = lane_slice<T>(J, C2, inverse) == 16;
    if (inverse)
      return narrow ? dwt_fused_inv<T, 512, kEvery, 16> : dwt_fused_inv<T, 512, kEvery, 32>;
    if (J > 512) return dwt_fused_fwd<T, 1024, kEvery, kCS1024>;
    return narrow ? dwt_fused_fwd<T, 512, kEvery, 16> : dwt_fused_fwd<T, 512, kEvery, 32>;
  } else {
    if (inverse)
      return J > 512 ? dwt_fused_inv<T, 1024, kEvery, kCS>
                     : dwt_fused_inv<T, 512, kEvery, kCS>;
    return J > 512 ? dwt_fused_fwd<T, 1024, kEvery, kCS> : dwt_fused_fwd<T, 512, kEvery, kCS>;
  }
}

template <typename T, bool kEvery>
int dispatch(bool inverse, const void* seeds, const void* m, const void* mp,
             const void* cb, const void* x, const void* l0s, const void* perm,
             void* y, int K, int J, int L, int C2, int tk, void* stream) {
  if (K <= 0 || L <= 0 || C2 <= 0 || tk <= 0) return int(cudaErrorInvalidValue);
  if (J <= 0 || J > 1024) return int(cudaErrorInvalidValue);
  const int cs = lane_slice<T>(J, C2, inverse);
  return int(launch_block<T>(
      pick_kernel<T, kEvery>(inverse, J, C2), inverse,
      dim3(K, (C2 + cs - 1) / cs, j_blocks<T>(J, inverse)), J, L, C2,
      static_cast<cudaStream_t>(stream), static_cast<const T*>(seeds),
      static_cast<const int*>(m), static_cast<const int*>(mp), static_cast<const T*>(cb),
      static_cast<const T*>(x), static_cast<const int*>(l0s), static_cast<const int*>(perm),
      static_cast<T*>(y), J, L, C2, tk));
}

}  // namespace

#define REPRO_FUSED_ENTRY(TNAME, T)                                                             \
  int dwt_fused_##TNAME(const void* seeds, const void* m, const void* mp, const void* cb,       \
                        const void* rhs, const void* l0s, const void* perm, void* out, int K,   \
                        int J, int L, int C2, int tk, void* stream) {                           \
    return dispatch<T, false>(false, seeds, m, mp, cb, rhs, l0s, perm, out, K, J, L, C2, tk,    \
                              stream);                                                          \
  }                                                                                             \
  int idwt_fused_##TNAME(const void* seeds, const void* m, const void* mp, const void* cb,      \
                         const void* lhs, const void* l0s, const void* perm, void* g, int K,    \
                         int J, int L, int C2, int tk, void* stream) {                          \
    return dispatch<T, false>(true, seeds, m, mp, cb, lhs, l0s, perm, g, K, J, L, C2, tk,       \
                              stream);                                                          \
  }                                                                                             \
  int dwt_onthefly_##TNAME(const void* seeds, const void* m, const void* mp, const void* cb,    \
                           const void* rhs, void* out, int K, int J, int L, int C2,             \
                           void* stream) {                                                      \
    return dispatch<T, true>(false, seeds, m, mp, cb, rhs, nullptr, nullptr, out, K, J, L, C2,  \
                             1, stream);                                                        \
  }                                                                                             \
  int idwt_onthefly_##TNAME(const void* seeds, const void* m, const void* mp, const void* cb,   \
                            const void* lhs, void* g, int K, int J, int L, int C2,              \
                            void* stream) {                                                     \
    return dispatch<T, true>(true, seeds, m, mp, cb, lhs, nullptr, nullptr, g, K, J, L, C2, 1,  \
                             stream);                                                           \
  }

extern "C" {

// Each returns the cudaError_t of the launch (0 = queued on `stream`).
// perm may be null (identity).
REPRO_FUSED_ENTRY(f32, float)
REPRO_FUSED_ENTRY(f64, double)

// Dynamic shared memory a launch at (J, L, C2) asks for, in bytes (the
// host-side estimate in kernels/autotune.py must agree).
long long dwt_fused_smem_bytes(int J, int L, int C2, int itemsize, int inverse) {
  if (itemsize == 4) return (long long)block_smem_bytes<float>(J, L, C2, inverse != 0);
  return (long long)block_smem_bytes<double>(J, L, C2, inverse != 0);
}

}  // extern "C"
