// l-chunked streaming DWT / iDWT and their window builder, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels `dwt_streaming` (_stream_fwd_kernel) and
// `idwt_streaming` (_stream_inv_kernel) of repro/kernels/streaming.py, and
// its jnp `build_windows` march:
//
//   build_windows:  win[lc] = (d_{l-1}, d_l) state at the start of degree
//                   l = lc * lchunk, marched from l = 0 (win[0] = 0)
//   forward:        out[k, l, c] = sum_j d_l[k, j] rhs[k, j, c]   (l >= l0)
//   inverse:        g[k, j, c]   = sum_{l >= l0} d_l[k, j] lhs[k, l, c]
//
// with the degree axis cut into nL = L / lchunk chunks, each resumed from
// its window.  Layout as in dwt_fused.cu (perm included), plus the window
// stack win (nL, 2, K, J) in the storage type S: T, or bfloat16 under
// precision "bf16", where each generated row is also rounded to bf16
// before the contraction while the recurrence state and the sums stay in
// T (reference: repro/kernels/streaming.py, module docstring).
//
// Every kernel here marches the recurrence through recurrence.cuh's
// wigner_coeffs / wigner_step and nothing else, and contracts through
// dwt_block.cuh's block body, as the fused kernels do.  The window
// builder stores exactly the state the fused kernels carry, so in fp32 /
// f64 the chunked results equal dwt_fused / idwt_fused bit for bit.
//
// What bounds them: as dwt_fused.cu (bytes, at B = 128 f64 V = 8), plus
// the window stack read once.  The forward reads the rhs slice once per
// chunk (each (cluster, lane slice, chunk) is its own block, so chunks of
// one cluster run in parallel; they are adjacent in the grid, so all but
// the first read it from L2) and pays a block's set-up (its coefficient
// triples, its rhs fragments, the first round's march) per chunk; the
// inverse recomputes the window march the fused kernels do anyway.
// Measured at lchunk 16 (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3,
// 700.00 W): at B = 128 f64 V = 8, 2.754 / 2.193 ms, 2.61 / 2.61x the
// byte bound (the forward took 3.98 ms while a cluster's chunks lay K
// blocks apart and each re-read its rhs from memory); at B = 64 f32
// V = 8, 0.138 / 0.127 ms against the f32 scalar body's 0.179 / 0.194
// (PERF.md §6).
//
// Design.
//   * build_windows: one block per cluster, one thread per j; coefficients
//     staged kLT degrees at a time in shared memory, as in the f32
//     scalar body.
//     The march starts at the cluster's m (the state is zero below it, as
//     the fused kernels start there too) and stores (d_prev, d_cur) at
//     each chunk boundary, rounded once on store under bf16.
//   * dwt_streaming: grid (nL, C2 / lane slice, K), chunks fastest (one
//     launch per 65535 clusters).  Block (lc, slice, k) loads its state
//     from win[lc] and runs
//     l = max(first degree, lc lchunk) .. (lc + 1) lchunk - 1, writing
//     zero rows below; chunks write disjoint rows, so they need no order.
//   * idwt_streaming: grid (K, C2 / lane slice[, j halves]).  One block
//     walks the chunks in ascending l, reloading the state from each
//     window, and keeps g's lane slice in registers across all of them:
//     the sums run in the same order as idwt_fused's.  No atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "dwt_block.cuh"

namespace {

using namespace repro;

// win[lc][s][k][j]
__host__ __device__ inline size_t win_index(int lc, int s, int k, int j, int K, int J) {
  return ((size_t(lc) * 2 + s) * K + k) * J + j;
}

template <typename T, typename S>
__global__ void __launch_bounds__(1024)
build_windows_kernel(const T* __restrict__ seeds, const int* __restrict__ m_arr,
                     const int* __restrict__ mp_arr, const T* __restrict__ cos_beta,
                     S* __restrict__ win, int K, int J, int nL, int lchunk) {
  __shared__ WignerCoeffs<T> coef[kLT];
  const int k = blockIdx.x;
  const int j = threadIdx.x;
  const bool j_ok = j < J;
  const int m = m_arr[k], mp = mp_arr[k];
  const T seed = j_ok ? seeds[size_t(k) * J + j] : T(0);
  const T cb = j_ok ? cos_beta[j] : T(0);
  const int lstop = (nL - 1) * lchunk;   // boundaries past it are never read
  const int lbeg = min(m, lstop);
  // windows at or below the start carry no history
  for (int lc = 0; lc * lchunk <= lbeg && lc < nL; ++lc)
    if (j_ok) {
      win[win_index(lc, 0, k, j, K, J)] = S(0.0f);
      win[win_index(lc, 1, k, j, K, J)] = S(0.0f);
    }
  T d_prev = T(0), d_cur = T(0);
  for (int lb = lbeg; lb < lstop; lb += kLT) {
    const int nlt = min(kLT, lstop - lb);
    if (threadIdx.x < nlt) coef[threadIdx.x] = wigner_coeffs<T>(lb + threadIdx.x, m, mp);
    __syncthreads();
    for (int t = 0; t < nlt; ++t) {
      const int l = lb + t;
      wigner_step<T>(coef[t], l, m, cb, seed, d_prev, d_cur);
      if ((l + 1) % lchunk == 0 && j_ok) {
        const int lc = (l + 1) / lchunk;
        win[win_index(lc, 0, k, j, K, J)] = store_state<S>(d_prev);
        win[win_index(lc, 1, k, j, K, J)] = store_state<S>(d_cur);
      }
    }
    __syncthreads();
  }
}

// kScalar: the f32 scalar body, the bit reference of the f32 kernels.
// Block (lc, slice, k - k0): a cluster's chunks are adjacent in the grid.
template <typename T, typename S, int kMaxThreads, int kCSl, bool kScalar = false>
__global__ void __launch_bounds__(kMaxThreads, 1)
dwt_stream_fwd(const T* __restrict__ seeds, const int* __restrict__ m_arr,
               const int* __restrict__ mp_arr, const T* __restrict__ cos_beta,
               const T* __restrict__ rhs, const int* __restrict__ l0s,
               const int* __restrict__ perm, const S* __restrict__ win,
               T* __restrict__ out, int K, int J, int L, int C2, int tk, int lchunk, int k0) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = k0 + blockIdx.z;
  const int row = perm ? perm[k] : k;
  const int c0 = blockIdx.y * kCSl;
  const int lc = blockIdx.x;
  const int base = lc * lchunk, lend = base + lchunk;
  const int j = threadIdx.x;
  const int m = m_arr[k], mp = mp_arr[k];
  const int lbeg = max(first_degree(l0s[k / tk], m, L), base);

  T* out_k = out + size_t(row) * L * C2;
  zero_rows(out_k, base, min(lbeg, lend), C2, c0, kCSl);
  if (lbeg >= lend) return;

  const bool j_ok = j < J;
  const T seed = j_ok ? seeds[size_t(k) * J + j] : T(0);
  const T cb = j_ok ? cos_beta[j] : T(0);
  T d_prev = j_ok ? load_state<T, S>(win[win_index(lc, 0, k, j, K, J)]) : T(0);
  T d_cur = j_ok ? load_state<T, S>(win[win_index(lc, 1, k, j, K, J)]) : T(0);
  constexpr bool kBf16 = sizeof(S) == 2;
  fwd_block<T, kCSl, kBf16, (kMaxThreads <= 512), kScalar>(
      lbeg, lend, m, mp, cb, seed, d_prev, d_cur, rhs + size_t(row) * J * C2, out_k, J, C2, c0,
      smem);
}

template <typename T, typename S, int kMaxThreads, int kCSl, bool kScalar = false>
__global__ void __launch_bounds__(kMaxThreads, 1)
dwt_stream_inv(const T* __restrict__ seeds, const int* __restrict__ m_arr,
               const int* __restrict__ mp_arr, const T* __restrict__ cos_beta,
               const T* __restrict__ lhs, const int* __restrict__ l0s,
               const int* __restrict__ perm, const S* __restrict__ win,
               T* __restrict__ g, int K, int J, int L, int C2, int tk, int lchunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = blockIdx.x;
  const int row = perm ? perm[k] : k;
  const int c0 = blockIdx.y * kCSl;
  const int j0 = blockIdx.z * blockDim.x;  // the block's j half (past J = 512)
  const int j = j0 + threadIdx.x;
  const bool j_ok = j < J;
  const int m = m_arr[k], mp = mp_arr[k];
  const int lbeg = first_degree(l0s[k / tk], m, L);

  using Body =
      std::conditional_t<kScalar, ScalarInvBody<T>, InvBody<T, kCSl, (kMaxThreads <= 512)>>;
  Body body(smem);
  const T seed = j_ok ? seeds[size_t(k) * J + j] : T(0);
  const T cb = j_ok ? cos_beta[j] : T(0);
  const auto from_window = [&](int lc, T& d_prev, T& d_cur) {
    d_prev = j_ok ? load_state<T, S>(win[win_index(lc, 0, k, j, K, J)]) : T(0);
    d_cur = j_ok ? load_state<T, S>(win[win_index(lc, 1, k, j, K, J)]) : T(0);
  };
  constexpr bool kBf16 = sizeof(S) == 2;
  body.template run<kBf16>(lbeg, L, lchunk, from_window, m, mp, cb, seed,
                           lhs + size_t(row) * L * C2, C2, c0);
  body.store(g + (size_t(row) * J + j0) * C2, J - j0, C2, c0);
}

// The instantiations a launch runs (as pick_kernel in dwt_fused.cu).
template <typename T, typename S, bool kScalar>
auto pick_fwd(int J, int C2) {
  if constexpr (is_f64<T>) {
    if (J > 512) return dwt_stream_fwd<T, S, 1024, kCS1024>;
    return lane_slice<T>(J, C2, false) == 16 ? dwt_stream_fwd<T, S, 512, 16>
                                             : dwt_stream_fwd<T, S, 512, 32>;
  } else if constexpr (kScalar) {
    return J > 512 ? dwt_stream_fwd<T, S, 1024, kCS, true> : dwt_stream_fwd<T, S, 512, kCS, true>;
  } else {
    return J > 512                          ? dwt_stream_fwd<T, S, 1024, 32>
           : lane_slice<T>(J, C2, false) == 64 ? dwt_stream_fwd<T, S, 512, 64>
                                               : dwt_stream_fwd<T, S, 512, 32>;
  }
}

template <typename T, typename S, bool kScalar>
auto pick_inv(int J, int C2) {
  if constexpr (is_f64<T>) {
    return lane_slice<T>(J, C2, true) == 16 ? dwt_stream_inv<T, S, 512, 16>
                                            : dwt_stream_inv<T, S, 512, 32>;
  } else if constexpr (kScalar) {
    return J > 512 ? dwt_stream_inv<T, S, 1024, kCS, true> : dwt_stream_inv<T, S, 512, kCS, true>;
  } else {
    const int cs = lane_slice<T>(J, C2, true);
    return cs == 128  ? dwt_stream_inv<T, S, 128, 128>
           : cs == 64 ? dwt_stream_inv<T, S, 512, 64>
                      : dwt_stream_inv<T, S, 512, 32>;
  }
}

// Clusters of one forward launch: grid z holds at most 65535.
constexpr int kMaxGridZ = 65535;

template <typename T, typename S, bool kScalar = false>
int dispatch(bool inverse, const void* seeds, const void* m, const void* mp, const void* cb,
             const void* x, const void* l0s, const void* perm, const void* win, void* y,
             int K, int J, int L, int C2, int tk, int lchunk, void* stream) {
  if (K <= 0 || L <= 0 || C2 <= 0 || tk <= 0 || lchunk <= 0 || L % lchunk || J <= 0 ||
      J > 1024)
    return int(cudaErrorInvalidValue);
  const int cs = lane_slice<T, kScalar>(J, C2, inverse);
  const int slices = (C2 + cs - 1) / cs;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const T*>(seeds);
  const auto* mi = static_cast<const int*>(m);
  const auto* mpi = static_cast<const int*>(mp);
  const auto* c = static_cast<const T*>(cb);
  const auto* xi = static_cast<const T*>(x);
  const auto* l0 = static_cast<const int*>(l0s);
  const auto* pm = static_cast<const int*>(perm);
  const auto* w = static_cast<const S*>(win);
  auto* out = static_cast<T*>(y);
  if (inverse)
    return int(launch_block<T, kScalar>(pick_inv<T, S, kScalar>(J, C2), true,
                                        dim3(K, slices, j_blocks<T, kScalar>(J, true)), J, L,
                                        C2, st, s, mi, mpi, c, xi, l0, pm, w, out, K, J, L, C2,
                                        tk, lchunk));
  for (int k0 = 0; k0 < K; k0 += kMaxGridZ) {
    const dim3 grid(L / lchunk, slices, std::min(kMaxGridZ, K - k0));
    const cudaError_t err =
        launch_block<T, kScalar>(pick_fwd<T, S, kScalar>(J, C2), false, grid, J, lchunk, C2, st, s,
                                 mi, mpi, c, xi, l0, pm, w, out, K, J, L, C2, tk, lchunk, k0);
    if (err != cudaSuccess) return int(err);
  }
  return int(cudaSuccess);
}

template <typename T, typename S>
int windows(const void* seeds, const void* m, const void* mp, const void* cb, void* win,
            int K, int J, int nL, int lchunk, void* stream) {
  if (K <= 0 || J <= 0 || J > 1024 || nL <= 0 || lchunk <= 0) return int(cudaErrorInvalidValue);
  build_windows_kernel<T, S><<<K, n_warps(J) * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(seeds), static_cast<const int*>(m), static_cast<const int*>(mp),
      static_cast<const T*>(cb), static_cast<S*>(win), K, J, nL, lchunk);
  return int(cudaGetLastError());
}

}  // namespace

#define REPRO_STREAMING_ENTRY(TNAME, T, PNAME, S)                                              \
  int build_windows_##TNAME##_##PNAME(const void* seeds, const void* m, const void* mp,        \
                                      const void* cb, void* win, int K, int J, int nL,         \
                                      int lchunk, void* stream) {                              \
    return windows<T, S>(seeds, m, mp, cb, win, K, J, nL, lchunk, stream);                     \
  }                                                                                            \
  REPRO_STREAMING_KERNELS(TNAME##_##PNAME, T, S, false)

#define REPRO_STREAMING_KERNELS(NAME, T, S, SCALAR)                                            \
  int dwt_streaming_##NAME(const void* seeds, const void* m, const void* mp, const void* cb,   \
                           const void* rhs, const void* l0s, const void* perm,                 \
                           const void* win, void* out, int K, int J, int L, int C2, int tk,    \
                           int lchunk, void* stream) {                                         \
    return dispatch<T, S, SCALAR>(false, seeds, m, mp, cb, rhs, l0s, perm, win, out, K, J, L,  \
                                  C2, tk, lchunk, stream);                                     \
  }                                                                                            \
  int idwt_streaming_##NAME(const void* seeds, const void* m, const void* mp, const void* cb,  \
                            const void* lhs, const void* l0s, const void* perm,                \
                            const void* win, void* g, int K, int J, int L, int C2, int tk,     \
                            int lchunk, void* stream) {                                        \
    return dispatch<T, S, SCALAR>(true, seeds, m, mp, cb, lhs, l0s, perm, win, g, K, J, L, C2, \
                                  tk, lchunk, stream);                                         \
  }

extern "C" {

// Each returns the cudaError_t of the launch (0 = queued on `stream`).
// perm may be null (identity).
REPRO_STREAMING_ENTRY(f32, float, fp32, float)
REPRO_STREAMING_ENTRY(f64, double, fp32, double)
REPRO_STREAMING_ENTRY(f32, float, bf16, __nv_bfloat16)
REPRO_STREAMING_ENTRY(f64, double, bf16, __nv_bfloat16)
// The f32 scalar body: the bit reference of the f32 kernels on the card.
// No wrapper calls these.
REPRO_STREAMING_KERNELS(f32_fp32_scalar, float, float, true)
REPRO_STREAMING_KERNELS(f32_bf16_scalar, float, __nv_bfloat16, true)

// Dynamic shared memory a dwt / idwt_streaming launch at (J, L, C2,
// lchunk) asks for, in bytes (the host-side estimate in
// kernels/autotune.py must agree): the forward's blocks march one
// l-chunk, the inverse's all of L.
long long streaming_smem_bytes(int J, int L, int C2, int lchunk, int itemsize, int inverse) {
  const int degrees = inverse ? L : lchunk;
  if (itemsize == 4) return (long long)block_smem_bytes<float>(J, degrees, C2, inverse != 0);
  return (long long)block_smem_bytes<double>(J, degrees, C2, inverse != 0);
}

}  // extern "C"
