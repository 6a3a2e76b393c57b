// Causal flash attention with the triangle fold, for sm_90a.
//
// Replaces the Pallas TPU kernel folded_causal_attention
// (src/repro/kernels/folded_attention.py: _folded_kernel, _naive_kernel,
// step _attn_step).  For each (batch, query head h), with kv head
// h / (Hq / Hkv), and each q-block qb of BQ rows, it runs the online
// softmax over kv blocks 0..qb in ascending order:
//
//     s     = (q_blk . k_blk^T) * scale          f32 sums of exact products
//     s     = -inf above the diagonal            on the diagonal block only
//     m'    = max(m, rowmax(s)),  p = exp(s - m'),  alpha = exp(m - m')
//     l     = l * alpha + rowsum(p)              p in f32, before rounding
//     acc   = acc * alpha + round_to_v_dtype(p) . v_blk     f32 sums
//     out   = acc / l                           cast to q's dtype
//
// Schedule.  On the TPU the fold saves grid slots of a sequential grid;
// here blocks run in parallel, so the fold is a work distribution.
// Folded: one block per (b*h, t), t < Qb/2, runs q-block t (t+1 kv
// steps) and then q-block Qb-1-t (Qb-t steps): Qb+1 steps in every
// block, no tail of short blocks.  Naive: one block per (b*h, q-block),
// the longest q-blocks first.  Both run one q-block through one device
// routine in the same kv order, so their outputs are equal bit for bit.
//
// What bounds it.  Per (b, h) the work is Qb(Qb+1)/2 block steps of
// 4 BQ^2 D operations (Q K^T and P V) against reading q, k, v and writing
// the output once: at the serving shape (S = 2048, D = 64, bf16) that is
// ~60 operations per byte, so the tensor cores bound it (989 TFLOP/s
// bf16).
//
// bf16 at BQ = mma_bq(D), 128 up to D = 128 and 64 at D = 192 / 256
// (folded_attention_bf16_kernel): FA2's register layout
// on mma.sync, the simple, sound step from scalar FMA.  A block of BQ/16 = 8
// warps runs one q-block at a time; warp w owns query rows 16w..16w+15.
// Q, K and V are bf16 tiles in shared memory, row-major by (row, d), rows
// padded by 8 bf16 so that ldmatrix is free of bank conflicts, and the d
// columns past D are zero (D = 36: Q K^T runs over a k-depth of 48, P V
// over an n-width of 40; only the first D output columns are stored).
//   - S = Q K^T: mma.sync.m16n8k16 bf16 x bf16 -> f32, Q as the A operand
//     and K (ldmatrix, non-transposed) as the .col B operand, k-steps of 16
//     over d in ascending order.  A bf16 product is exact in f32, so this
//     is the reference's function; only the order and rounding of the f32
//     sums differ.  The 16 x BQ score tile stays in registers (64).  Q is
//     read with ldmatrix at every k-step, as FA2 does by default, not held
//     in registers: D = 64 needs all of the 128 registers that two blocks
//     of 256 threads per SM leave.
//   - The softmax works on those registers, one step per kv block as in
//     the reference (a step of 64 keys would round p against a partial
//     max and fail chip_smoke's limit): the row max and row sum over the
//     quad of threads that share a row (2 __shfl_xor_sync), m and l per row
//     in registers, l from the f32 p.  It runs in base 2: the scale carries
//     log2(e), p = exp2f(s - m), one MUFU per exponential.
//   - P V with P from registers: p is rounded to bf16 and the C fragments
//     of two n8 score tiles become the A fragment of one k16 step (no trip
//     through shared memory, and the 64 score registers are free again); V
//     is read with ldmatrix.trans as the B operand.  Each kv block's P V
//     is summed from zero, one n8 output tile at a time, and added onto
//     acc * alpha in round-to-nearest, as the reference adds its block
//     product.  The tensor cores round their f32 sums toward zero; chained
//     onto acc over every kv block, that truncation would pile up 8 (qb+1)
//     times in each output.
//   - K and V load with cp.async into a two-stage ring: kv block j+1's K
//     is in flight while block j computes S, its V while block j computes
//     P V.  The copy width (16, 8 or 4 bytes, or element by element) is
//     chosen at each tile load from the strides and the base address, so
//     (B, S, H, D) projections pass as transposed views at any D.  The
//     copy loops stay rolled and the q-block routine has one call site:
//     unrolled, the copies' hoisted addresses spilled.
//   - The epilogue writes O / l as bf16 through the output's strides.
//   Accuracy: p's rounding to bf16 turns an ulp of difference in a score
//   into a bf16 step of p, so against the plain version's sequential f32
//   sums a few outputs in a thousand round to the neighbouring bf16 value
//   (l2 ~5e-5 at the serving shape, as torch's own
//   scaled_dot_product_attention reads), within chip_smoke's ATTN_TOL.
//   Shared memory per block: Q plus two stages of K and V, 5 BQ (DK + 8)
//   bf16 = 92,160 bytes at D = 64 (two blocks per SM, 128 registers),
//   174,080 at D = 128 (one block).  At D = 192 and 256 that is over the
//   227 KB of a block at BQ = 128, so the tensor-core kernel runs BQ = 64
//   there (4 warps, 128,000 / 168,960 bytes, one block per SM; the
//   accumulator alone is D / 2 registers a thread), and bf16 below BQ 64
//   takes the scalar kernel.  What bounds this design: every warp
//   reads the whole K and V tiles with ldmatrix, mma.sync does not reach
//   the rate of wgmma, and the folded grid's 576 equal blocks at the
//   serving shape fill 264 block slots in 2.2 waves; wgmma with a TMA ring
//   and warp specialisation is the next step.
//
// f32, and bf16 at BQ < mma_bq(D): scalar FMA
// (folded_attention_scalar_kernel).
// f32 on the tensor cores would be TF32, another function.  bf16 at
// BQ < mma_bq(D) (prompts of at most 128 tokens in the serve path, 64 at
// D = 192 / 256, a few microseconds of work) keeps the scalar kernel because its sums run in the
// plain version's order: sequential over d and over keys.  At bf16 ties of
// a short prompt's logits, the tensor cores' order (and torch's
// scaled_dot_product_attention's) picks another greedy token than the
// plain-attention model (chip_smoke.py phase 7b, prompt 40).  Each thread
// owns a (BQ/16) x (BQ/16) tile of the scores and a (BQ/16) x ceil(D/16)
// tile of the accumulator in registers; q, k-or-v and the score tile are
// f32 in shared memory (rows padded to an odd stride), 199,680 bytes at
// BQ = 128, D = 128, one block of 256 threads per SM; 148,992 at BQ = 64,
// D = 256.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

typedef long long ll;
typedef __nv_bfloat16 bf16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Hq, group, S;
  ll qs[4], ks[4], vs[4], os[4];   // element strides (b, h, s, d)
  float scale;
};

// ===========================================================================
// scalar FMA from shared memory: f32, and bf16 at BQ < mma_bq(D)
// ===========================================================================

constexpr int kScalarThreads = 256;

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
__device__ __forceinline__ void load_scalar_tile(float* dst, const T* src,
                                                 ll s_stride, ll d_stride,
                                                 int row0) {
  for (int e = threadIdx.x; e < BQ * D; e += kScalarThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] =
        to_f32<T>(src[(ll)(row0 + r) * s_stride + (ll)c * d_stride]);
  }
}

// One online-softmax block update of q-block qb against kv-block kv.
template <typename T, int BQ, int D>
__device__ __forceinline__ void scalar_block_step(
    const Params& p, const T* k, const T* v, int kv, bool diag,
    float* Qs, float* KV, float* Ps, float* m_s, float* l_s, float* a_s,
    float (&acc)[BQ / 16][(D + 15) / 16]) {
  constexpr int LDD = D + 1, LDP = BQ + 1;
  constexpr int RT = BQ / 16, CT = BQ / 16, DC = (D + 15) / 16;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  __syncthreads();                       // the last step's P V read KV
  load_scalar_tile<T, BQ, D>(KV, k, p.ks[2], p.ks[3], kv * BQ);
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

  load_scalar_tile<T, BQ, D>(KV, v, p.vs[2], p.vs[3], kv * BQ);
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BQ; r += kScalarThreads / 32) {
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
__device__ void scalar_attend_qblock(const Params& p, const T* q,
                                     const T* k, const T* v, T* o, int qb,
                                     float* smem) {
  constexpr int RT = BQ / 16, DC = (D + 15) / 16;
  float* Qs = smem;
  float* KV = Qs + BQ * (D + 1);
  float* Ps = KV + BQ * (D + 1);
  float* m_s = Ps + BQ * (BQ + 1);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  __syncthreads();                       // the last q-block read l_s, Qs
  load_scalar_tile<T, BQ, D>(Qs, q, p.qs[2], p.qs[3], qb * BQ);
  for (int r = tid; r < BQ; r += kScalarThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  float acc[RT][DC];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int kv = 0; kv <= qb; ++kv)
    scalar_block_step<T, BQ, D>(p, k, v, kv, kv == qb, Qs, KV, Ps, m_s, l_s,
                                a_s, acc);

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
__global__ void __launch_bounds__(kScalarThreads)
    folded_attention_scalar_kernel(Params p, int folded) {
  extern __shared__ float scalar_smem[];
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int hk = h / p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  T* o = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1];
  const int nqb = p.S / BQ;
  if (folded) {
    const int t = blockIdx.y;
    scalar_attend_qblock<T, BQ, D>(p, q, k, v, o, t, scalar_smem);
    scalar_attend_qblock<T, BQ, D>(p, q, k, v, o, nqb - 1 - t, scalar_smem);
  } else {
    scalar_attend_qblock<T, BQ, D>(p, q, k, v, o, blockIdx.y, scalar_smem);
  }
}

// ===========================================================================
// bf16: mma.sync tensor cores, FA2's register layout
// ===========================================================================

// The largest q-block of each head width (every kernel's shared memory
// fits a block's 227 KB): 128 up to D = 128; 64 at D = 192 and 256, where
// five bf16 tiles at BQ = 128 take 256,000 / 337,920 bytes and the f32
// scalar kernel's tiles 265,216 / 330,752.
__host__ __device__ constexpr int max_bq(int d) { return d > 128 ? 64 : 128; }

// the q-block of the tensor-core kernel: the head width's largest
__host__ __device__ constexpr int mma_bq(int d) { return max_bq(d); }

__host__ __device__ constexpr int bf16_ld(int d) {   // smem row stride
  return (d + 15) / 16 * 16 + 8;
}

__host__ __device__ constexpr int bf16_smem_bytes(int bq, int d) {
  return 5 * bq * bf16_ld(d) * (int)sizeof(bf16);    // Q, 2 x K, 2 x V
}

template <int BQ, int D>
struct Tile {
  static constexpr int kThreads = 2 * BQ;         // a warp per 16 rows
  static constexpr int DK = (D + 15) / 16 * 16;   // k-depth of Q K^T
  static constexpr int DN = (D + 7) / 8 * 8;      // n-width of P V
  static constexpr int LD = bf16_ld(D);           // row stride, elements
  static constexpr int kElems = BQ * LD;          // one tile
  static constexpr int NT = BQ / 8;               // n8 score tiles per warp
  static constexpr int OT = DN / 8;               // n8 output tiles per warp
  // two blocks of 256 threads per SM where the shared memory allows it
  static constexpr int kMinBlocks = 2 * bf16_smem_bytes(BQ, D) <= 227 * 1024
                                        ? 2 : 1;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int W>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(dst), "l"(src), "n"(W) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the N most recently committed groups have landed
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(unsigned addr, unsigned (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// c += a . b: a 16 x 16 (row), b 16 x 8 (col), c 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16; lo in the low half (the lower column)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Widest copy, in bytes, that every row of a (b, h) slice allows: 16, 8
// or 4 when d is contiguous and the rows start W-aligned, else 2 (one
// element at a time).
template <int D>
__device__ __forceinline__ int copy_width(const void* base, ll s_stride,
                                          ll d_stride) {
  if (d_stride != 1) return 2;
  const unsigned long long a = reinterpret_cast<unsigned long long>(base);
  for (int w = 16; w >= 4; w /= 2)
    if ((2 * D) % w == 0 && a % w == 0 && (2 * s_stride) % w == 0) return w;
  return 2;
}

// rows [row0, row0 + BQ), columns [0, D) of one (b, h) slice -> dst
// (row stride LD) in W-byte copies: cp.async for W >= 4, plain loads and
// stores for W = 2.  Columns D..LD-1 are never written.  The loops stay
// rolled: unrolled, the compiler hoists every copy's 64-bit address out of
// the kv loop, and those registers spill at two blocks per SM.
template <int BQ, int D, int W>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          ll s_stride, ll d_stride,
                                          int row0) {
  using T = Tile<BQ, D>;
  if constexpr (W == 2) {
#pragma unroll 1
    for (int e = threadIdx.x; e < BQ * D; e += T::kThreads) {
      const int r = e / D, c = e % D;
      dst[r * T::LD + c] = src[(ll)(row0 + r) * s_stride + (ll)c * d_stride];
    }
  } else {
    constexpr int kPer = W / 2, kChunks = D / kPer;
#pragma unroll 1
    for (int e = threadIdx.x; e < BQ * kChunks; e += T::kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * kPer;
      cp_async<W>(smem_addr(dst + r * T::LD + c),
                  src + (ll)(row0 + r) * s_stride + c);
    }
  }
}

// the copy width is chosen at each call, from the slice's base address
// and strides: kept across the kv loop, it would hold registers that
// BQ = 128, D = 64 does not have
template <int BQ, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          ll s_stride, ll d_stride,
                                          int row0) {
  const int width = copy_width<D>(src, s_stride, d_stride);
  if (width == 16) {
    if constexpr (D % 8 == 0)
      load_rows<BQ, D, 16>(dst, src, s_stride, d_stride, row0);
  } else if (width == 8) {
    if constexpr (D % 4 == 0)
      load_rows<BQ, D, 8>(dst, src, s_stride, d_stride, row0);
  } else if (width == 4) {
    load_rows<BQ, D, 4>(dst, src, s_stride, d_stride, row0);
  } else {
    load_rows<BQ, D, 2>(dst, src, s_stride, d_stride, row0);
  }
}

// q-block qb of one (b, h): kv blocks 0..qb, then the output rows.
template <int BQ, int D>
__device__ __forceinline__ void bf16_attend_qblock(
    const Params& p, const bf16* q, const bf16* k, const bf16* v, bf16* o,
    int qb, bf16* smem) {
  using T = Tile<BQ, D>;
  constexpr int LD = T::LD, NT = T::NT, OT = T::OT, KS = T::DK / 16;
  bf16* Qs = smem;
  bf16* Ks = Qs + T::kElems;             // two stages
  bf16* Vs = Ks + 2 * T::kElems;         // two stages
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row, column pair
  const int mi = lane / 8, r8 = lane % 8;   // ldmatrix matrix, row

  __syncthreads();                       // the last q-block is done with smem
  load_tile<BQ, D>(Qs, q, p.qs[2], p.qs[3], qb * BQ);
  load_tile<BQ, D>(Ks, k, p.ks[2], p.ks[3], 0);
  cp_commit();
  load_tile<BQ, D>(Vs, v, p.vs[2], p.vs[3], 0);
  cp_commit();

  // this lane's ldmatrix row addresses: Q as the A operand (matrices
  // rows 0-7 / 8-15 x cols 0-7 / 8-15), K as B (keys 0-7 / 8-15 of two n8
  // tiles x d 0-7 / 8-15), V transposed as B (keys 0-7 / 8-15 of one n8
  // tile; .x2 reads the addresses of lanes 0-15)
  const unsigned q_a = smem_addr(Qs + (16 * warp + (mi & 1) * 8 + r8) * LD +
                                 (mi >> 1) * 8);
  const int k_off = ((mi >> 1) * 8 + r8) * LD + (mi & 1) * 8;
  const int v_off = (lane % 16) * LD;
  const int row = 16 * warp + g;         // this thread's rows: row, row + 8
  // exp(x) = exp2(x log2 e): the scores and m in units of log2, one MUFU
  // per exponential
  const float scale2 = p.scale * 1.4426950408889634f;

  float acc[OT][4];
#pragma unroll
  for (int i = 0; i < OT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kv = 0; kv <= qb; ++kv) {
    const int st = kv & 1;
    const bool more = kv < qb;
    cp_wait<1>();                        // K[kv] (and Q) landed
    __syncthreads();                     // ... for every thread; and
                                         // stage st^1 is no longer read
    if (more) {
      load_tile<BQ, D>(Ks + (st ^ 1) * T::kElems, k, p.ks[2], p.ks[3],
                       (kv + 1) * BQ);
      cp_commit();
    }
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const unsigned k_a = smem_addr(Ks + st * T::kElems + k_off);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned a[4];
      ldsm_x4(q_a + kk * 32, a);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        unsigned b[4];
        ldsm_x4(k_a + (j * 16 * LD + kk * 16) * 2, b);
        mma_bf16(s[2 * j], a, b[0], b[1]);
        mma_bf16(s[2 * j + 1], a, b[2], b[3]);
      }
    }

    // scale, mask, online softmax; s[j][e] is row (row + 8 (e / 2)),
    // key 8 j + 2 t + e % 2 of the block
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], scale2);
        if (!more && 8 * j + 2 * t + (e & 1) > row + 8 * (e >> 1))
          x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), sum[h]);
    }
    // p rounded to bf16: the C fragments of n8 score tiles 2 kk and
    // 2 kk + 1 are the A fragment of P V's k-step kk
    unsigned pa[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    if (more)
      cp_wait<1>();                      // V[kv] landed, K[kv+1] may not
    else
      cp_wait<0>();
    __syncthreads();
    if (more) {
      load_tile<BQ, D>(Vs + (st ^ 1) * T::kElems, v, p.vs[2], p.vs[3],
                       (kv + 1) * BQ);
      cp_commit();
    }

    // acc = acc * alpha + round_bf16(p) . v_blk, as the reference adds
    // its block product: per n8 output tile, the block's products are
    // summed from zero by the tensor cores in k-steps of 16 keys and added
    // onto the rescaled acc in round-to-nearest
    const unsigned v_a = smem_addr(Vs + st * T::kElems + v_off);
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      float pv[4] = {};
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        unsigned b[2];
        ldsm_x2_t(v_a + (kk * 16 * LD + i * 8) * 2, b);
        mma_bf16(pv, pa[kk], b[0], b[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[i][e] = __fadd_rn(__fmul_rn(acc[i][e], alpha[e >> 1]), pv[e]);
    }
  }

  const bool o_pairs = p.os[3] == 1 && p.os[2] % 2 == 0 &&
                       reinterpret_cast<unsigned long long>(o) % 4 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* orow = o + (ll)(qb * BQ + row + 8 * h) * p.os[2];
#pragma unroll
    for (int i = 0; i < OT; ++i) {
      const int c = 8 * i + 2 * t;       // D is even: c, c + 1 < D or not
      if (c < D) {
        const float x0 = acc[i][2 * h] / l[h], x1 = acc[i][2 * h + 1] / l[h];
        if (o_pairs) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          orow[(ll)c * p.os[3]] = __float2bfloat16_rn(x0);
          orow[(ll)(c + 1) * p.os[3]] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

// blockIdx.x = b * Hq + h; blockIdx.y = t (folded) or the q-block (naive,
// the longest first)
template <int BQ, int D>
__global__ void __launch_bounds__(Tile<BQ, D>::kThreads,
                                  Tile<BQ, D>::kMinBlocks)
    folded_attention_bf16_kernel(Params p, int folded) {
  using T = Tile<BQ, D>;
  extern __shared__ __align__(16) unsigned char bf16_smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(bf16_smem_raw);
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int hk = h / p.group;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks[0] + hk * p.ks[1];
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs[0] + hk * p.vs[1];
  bf16* o = static_cast<bf16*>(p.o) + b * p.os[0] + h * p.os[1];

  // zero columns D..LD-1 of the five tiles once; loads never write them
  constexpr int kPad = T::LD - D;
  for (int e = threadIdx.x; e < 5 * BQ * kPad; e += T::kThreads)
    smem[(e / kPad) * T::LD + D + e % kPad] = __float2bfloat16_rn(0.f);

  const int nqb = p.S / BQ;
  const int first = folded ? (int)blockIdx.y : nqb - 1 - (int)blockIdx.y;
#pragma unroll 1
  for (int i = 0; i < (folded ? 2 : 1); ++i)      // one copy of the code
    bf16_attend_qblock<BQ, D>(p, q, k, v, o, i ? nqb - 1 - first : first,
                              smem);
}

// ===========================================================================
// launch
// ===========================================================================

// Allow the kernel its dynamic shared memory; with blocks != null, report
// its resident blocks per SM instead of launching.
template <typename Kern>
int prepare(Kern kern, int threads, int smem, int* blocks) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess || !blocks) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                           threads, smem);
}

template <typename Kern>
int start(Kern kern, int threads, int smem, dim3 grid, const Params& p,
          int folded, cudaStream_t stream, int* blocks) {
  const int err = prepare(kern, threads, smem, blocks);
  if (err || blocks) return err;
  kern<<<grid, threads, smem, stream>>>(p, folded);
  return (int)cudaGetLastError();
}

// bf16 at BQ = mma_bq(D) on the tensor cores; f32, and bf16 at smaller BQ, on
// the scalar kernel
template <int BQ, int D>
int launch_t(const Params& p, int is_bf16, int BH, int folded,
             cudaStream_t stream, int* blocks) {
  const int nqb = p.S / BQ;
  const dim3 grid(BH, folded ? nqb / 2 : nqb);
  constexpr int scalar_smem = smem_floats(BQ, D) * (int)sizeof(float);
  if (!is_bf16)
    return start(folded_attention_scalar_kernel<float, BQ, D>,
                 kScalarThreads, scalar_smem, grid, p, folded, stream,
                 blocks);
  if constexpr (BQ == mma_bq(D))
    return start(folded_attention_bf16_kernel<BQ, D>, Tile<BQ, D>::kThreads,
                 bf16_smem_bytes(BQ, D), grid, p, folded, stream, blocks);
  else
    return start(folded_attention_scalar_kernel<bf16, BQ, D>,
                 kScalarThreads, scalar_smem, grid, p, folded, stream,
                 blocks);
}

template <int BQ>
int by_d(const Params& p, int is_bf16, int D, int BH, int folded,
         cudaStream_t s, int* blocks) {
  switch (D) {
    case 32: return launch_t<BQ, 32>(p, is_bf16, BH, folded, s, blocks);
    case 36: return launch_t<BQ, 36>(p, is_bf16, BH, folded, s, blocks);
    case 64: return launch_t<BQ, 64>(p, is_bf16, BH, folded, s, blocks);
    case 128: return launch_t<BQ, 128>(p, is_bf16, BH, folded, s, blocks);
  }
  if constexpr (BQ <= max_bq(192)) {
    switch (D) {
      case 192: return launch_t<BQ, 192>(p, is_bf16, BH, folded, s, blocks);
      case 256: return launch_t<BQ, 256>(p, is_bf16, BH, folded, s, blocks);
    }
  }
  return (int)cudaErrorInvalidValue;
}

int by_bq(const Params& p, int is_bf16, int bq, int D, int BH, int folded,
          cudaStream_t s, int* blocks) {
  switch (bq) {
    case 16: return by_d<16>(p, is_bf16, D, BH, folded, s, blocks);
    case 32: return by_d<32>(p, is_bf16, D, BH, folded, s, blocks);
    case 64: return by_d<64>(p, is_bf16, D, BH, folded, s, blocks);
    case 128: return by_d<128>(p, is_bf16, D, BH, folded, s, blocks);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block, bytes.
long long folded_attention_smem_bytes(int bq, int D, int is_bf16) {
  return is_bf16 && bq == mma_bq(D)
             ? (long long)bf16_smem_bytes(bq, D)
             : (long long)smem_floats(bq, D) * (long long)sizeof(float);
}

// Resident blocks per SM of the compiled kernel of (bq, D, dtype), into
// *blocks.  Returns a cudaError_t.
int folded_attention_blocks_per_sm(int bq, int D, int is_bf16, int* blocks) {
  const Params p = {};
  return by_bq(p, is_bf16, bq, D, 1, 1, nullptr, blocks);
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
      bq > max_bq(D) || (folded && (S / bq) % 2))
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
  return by_bq(p, is_bf16, bq, D, B * Hq, folded,
               static_cast<cudaStream_t>(stream), nullptr);
}

}  // extern "C"
