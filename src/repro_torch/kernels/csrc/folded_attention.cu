// Causal flash attention with the triangle fold, for sm_90a.
//
// Replaces the Pallas TPU kernel folded_causal_attention
// (src/repro/kernels/folded_attention.py: _folded_kernel, _naive_kernel,
// step _attn_step).  For each (batch, query head h), with kv head
// h / (Hq / Hkv), and each q-block qb of BQ rows, it runs the online
// softmax over kv blocks 0..qb in ascending order:
//
//     s     = (q_blk . k_blk^T) * scale          f32, inputs upcast to f32
//     s     = -inf above the diagonal            on the diagonal block only
//     m'    = max(m, rowmax(s)),  p = exp(s - m'),  alpha = exp(m - m')
//     l     = l * alpha + rowsum(p)
//     acc   = acc * alpha + round_to_v_dtype(p) . v_blk     f32 sums
//     out   = acc / l                           cast to q's dtype
//
// Schedule.  On the TPU the fold saves grid slots of a sequential grid;
// here blocks run in parallel, so the fold is a work distribution.
// Folded: one block per (b*h, t), t < Qb/2, runs q-block t (t+1 kv
// steps) and then q-block Qb-1-t (Qb-t steps): Qb+1 steps in every
// block, no tail of short blocks.  Naive: one block per (b*h, q-block),
// with unequal work.  Both run one q-block through attend_qblock and the
// same block_step in the same order, so their outputs are equal bit for
// bit.
//
// What bounds it.  Per (b, h) the work is Qb(Qb+1)/2 block steps of
// 4 BQ^2 D operations (Q K^T and P V) against reading q, k, v and writing
// the output once: at the serving shape (S = 2048, D = 64, bf16) that is
// ~60 operations per byte, so the tensor cores bound it (989 TFLOP/s
// bf16).  This first version does not reach them: it is the simple, right
// kernel.  Its products are scalar f32 FMAs from shared memory (bf16
// inputs are widened to f32, their products are exact; f32 inputs never
// go through TF32), each thread owning a (BQ/16) x (BQ/16) tile of the
// scores and a (BQ/16) x ceil(D/16) tile of the accumulator in
// registers.  q, k, v and the output are read and written through their
// strides, so (B, S, H, D) projections pass as transposed views.
//
// One block: 256 threads; dynamic shared memory holds the q tile, one
// k-or-v tile and the score tile in f32 (rows padded to an odd stride)
// and the per-row m, l, alpha: 199,680 bytes at BQ = 128, D = 128.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
typedef long long ll;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, group, S;
  ll qs[4], ks[4], vs[4], os[4];   // element strides (b, h, s, d)
  float scale;
};

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int smem_floats(int bq, int d) {
  return 2 * bq * (d + 1) + bq * (bq + 1) + 3 * bq;
}

// rows [row0, row0 + BQ) of one (b, h) slice -> dst (f32, row stride D+1)
template <typename T, int BQ, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          ll s_stride, ll d_stride,
                                          int row0) {
  for (int e = threadIdx.x; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] =
        to_f32<T>(src[(ll)(row0 + r) * s_stride + (ll)c * d_stride]);
  }
}

// One online-softmax block update of q-block qb against kv-block kv.
template <typename T, int BQ, int D>
__device__ __forceinline__ void block_step(
    const Params& p, const T* k, const T* v, int kv, bool diag,
    float* Qs, float* KV, float* Ps, float* m_s, float* l_s, float* a_s,
    float (&acc)[BQ / 16][(D + 15) / 16]) {
  constexpr int LDD = D + 1, LDP = BQ + 1;
  constexpr int RT = BQ / 16, CT = BQ / 16, DC = (D + 15) / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  __syncthreads();                       // the last step's P V read KV
  load_tile<T, BQ, D>(KV, k, p.ks[2], p.ks[3], kv * BQ);
  __syncthreads();

  float s[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RT], b[CT];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = Qs[(ty + 16 * i) * LDD + d];
#pragma unroll
    for (int j = 0; j < CT; ++j) b[j] = KV[(tx + 16 * j) * LDD + d];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const float x = s[i][j] * p.scale;
      Ps[r * LDP + c] = (diag && c > r) ? -INFINITY : x;
    }
  __syncthreads();                       // scores complete, K no longer read

  load_tile<T, BQ, D>(KV, v, p.vs[2], p.vs[3], kv * BQ);
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BQ; r += kThreads / 32) {
    float mx = -INFINITY;
    for (int c = lane; c < BQ; c += 32) mx = fmaxf(mx, Ps[r * LDP + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_prev = m_s[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int c = lane; c < BQ; c += 32) {
      const float e = expf(Ps[r * LDP + c] - m_new);
      sum += e;
      Ps[r * LDP + c] = to_f32<T>(from_f32<T>(e));   // p in v's dtype
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
  }
  __syncthreads();                       // V tile, p and alpha complete

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float alpha = a_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
  }
#pragma unroll 4
  for (int kk = 0; kk < BQ; ++kk) {
    float pr[RT], vv[DC];
#pragma unroll
    for (int i = 0; i < RT; ++i) pr[i] = Ps[(ty + 16 * i) * LDP + kk];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      vv[j] = (c < D) ? KV[kk * LDD + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
  }
}

// q-block qb of one (b, h): kv blocks 0..qb, then the output rows.
template <typename T, int BQ, int D>
__device__ void attend_qblock(const Params& p, const T* q, const T* k,
                              const T* v, T* o, int qb, float* smem) {
  constexpr int RT = BQ / 16, DC = (D + 15) / 16;
  float* Qs = smem;
  float* KV = Qs + BQ * (D + 1);
  float* Ps = KV + BQ * (D + 1);
  float* m_s = Ps + BQ * (BQ + 1);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  __syncthreads();                       // the last q-block read l_s, Qs
  load_tile<T, BQ, D>(Qs, q, p.qs[2], p.qs[3], qb * BQ);
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  float acc[RT][DC];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int kv = 0; kv <= qb; ++kv)
    block_step<T, BQ, D>(p, k, v, kv, kv == qb, Qs, KV, Ps, m_s, l_s, a_s,
                         acc);

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty + 16 * i;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = tx + 16 * j;
      if (c < D)
        o[(ll)(qb * BQ + r) * p.os[2] + (ll)c * p.os[3]] =
            from_f32<T>(acc[i][j] / l);
    }
  }
}

// blockIdx.x = b * Hq + h; blockIdx.y = t (folded) or the q-block (naive)
template <typename T, int BQ, int D>
__global__ void __launch_bounds__(kThreads)
    folded_attention_kernel(Params p, int folded) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int hk = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  T* o = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1];
  const int nqb = p.S / BQ;
  if (folded) {
    const int t = blockIdx.y;
    attend_qblock<T, BQ, D>(p, q, k, v, o, t, smem);
    attend_qblock<T, BQ, D>(p, q, k, v, o, nqb - 1 - t, smem);
  } else {
    attend_qblock<T, BQ, D>(p, q, k, v, o, blockIdx.y, smem);
  }
}

template <typename T, int BQ, int D>
int launch_t(const Params& p, int BH, int folded, cudaStream_t stream) {
  const int smem = smem_floats(BQ, D) * (int)sizeof(float);
  auto kern = folded_attention_kernel<T, BQ, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = p.S / BQ;
  dim3 grid(BH, folded ? nqb / 2 : nqb);
  kern<<<grid, kThreads, smem, stream>>>(p, folded);
  return (int)cudaGetLastError();
}

template <typename T, int BQ>
int by_d(const Params& p, int D, int BH, int folded, cudaStream_t s) {
  switch (D) {
    case 32: return launch_t<T, BQ, 32>(p, BH, folded, s);
    case 36: return launch_t<T, BQ, 36>(p, BH, folded, s);
    case 64: return launch_t<T, BQ, 64>(p, BH, folded, s);
    case 128: return launch_t<T, BQ, 128>(p, BH, folded, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_bq(const Params& p, int bq, int D, int BH, int folded,
          cudaStream_t s) {
  switch (bq) {
    case 16: return by_d<T, 16>(p, D, BH, folded, s);
    case 32: return by_d<T, 32>(p, D, BH, folded, s);
    case 64: return by_d<T, 64>(p, D, BH, folded, s);
    case 128: return by_d<T, 128>(p, D, BH, folded, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, bytes.
long long folded_attention_smem_bytes(int bq, int D) {
  return (long long)smem_floats(bq, D) * (long long)sizeof(float);
}

// q, o: (B, Hq, S, D); k, v: (B, Hkv, S, D), all of one dtype (bf16 when
// is_bf16, else f32), addressed through the element strides given.
// Returns the cudaError_t of the launch.
int folded_attention_launch(const void* q, const void* k, const void* v,
                            void* o, int is_bf16, int B, int Hq, int Hkv,
                            int S, int D, int bq, int folded,
                            int qs0, int qs1, int qs2, int qs3,
                            int ks0, int ks1, int ks2, int ks3,
                            int vs0, int vs1, int vs2, int vs3,
                            int os0, int os1, int os2, int os3,
                            float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || S % bq ||
      (folded && (S / bq) % 2))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.Hq = Hq;
  p.group = Hq / Hkv;
  p.S = S;
  const int qs[4] = {qs0, qs1, qs2, qs3}, ks[4] = {ks0, ks1, ks2, ks3};
  const int vs[4] = {vs0, vs1, vs2, vs3}, os[4] = {os0, os1, os2, os3};
  for (int i = 0; i < 4; ++i) {
    p.qs[i] = qs[i];
    p.ks[i] = ks[i];
    p.vs[i] = vs[i];
    p.os[i] = os[i];
  }
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? by_bq<__nv_bfloat16>(p, bq, D, B * Hq, folded, s)
                 : by_bq<float>(p, bq, D, B * Hq, folded, s);
}

}  // extern "C"
