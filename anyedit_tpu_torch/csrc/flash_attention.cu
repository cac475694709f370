// K3: online-softmax attention on tensor cores for Hopper (sm_90a), any Lq / Lkv.
//
// Replaces the TPU kernel `anyedit_tpu/ops/attention.py::_flash_kernel`
// (wrapper `flash_attention`). Same function, fp32 softmax throughout:
//   s = q k^T * scale,  s = -inf where col >= kv_len
//   for each key tile:  m_new = max(m, rowmax(s)),  p = exp(s - m_new),
//     c = exp(m - m_new),  l = l * c + rowsum(p),  acc = acc * c + p v
//   o = acc / max(l, 1e-30), cast to q's dtype.
// Tiles past kv_len are never visited and the first tile holds key 0, so m
// is finite after it and exp(m - m_new) never meets -inf - (-inf).
//
// Rounding points. The logits run in base 2: p = ex2(s * scale * log2(e) -
// m), one FFMA and one MUFU `ex2.approx` a logit, with m the running max
// of the scaled logits (scale > 0, so the max is taken on the raw S).
//   * bf16 inputs: S = q k^T on `mma.sync.m16n8k16` from the bf16 q and k
//     as they are (exact products, fp32 accumulation), scaled in fp32
//     afterwards (the JAX kernel scales q first: one fp32 rounding apart).
//     P.V at fp32 accuracy on bf16 MMAs: p = p_hi + p_lo with p_hi =
//     bf16(p) and p_lo = bf16(p - p_hi), two MMAs against the same V
//     fragments; the residual is about 2^-17 of p. l sums the unrounded
//     fp32 p.
//   * fp32 inputs: 3xTF32 on `mma.sync.m16n8k8.tf32`. Each operand x
//     splits into big = tf32(x) and small = tf32(x - big) (round to
//     nearest), and each product is small.big + big.small + big.big
//     (CUTLASS's fast-fp32 recipe): the missing small.small term is about
//     2^-22 of the product. One TF32 pass would miss the 2e-5 bound.
//
// Design. A warp owns one m16 tile of q rows; a block has 1, 2, 4 or 8
// warps (the wrapper chooses by D, from a sweep: `_k3_warps`). S
// stays in the accumulator registers, where the scale, the mask, the row
// max (a lane quad reduces with two shuffles), the exp and the row sums
// run; each thread keeps partial row sums, reduced once at the end. P goes
// from the accumulators straight into the A fragments of the PV product:
//   * bf16: the m16n8 accumulators of two n8 key tiles are exactly an
//     m16n8k16 A fragment once packed to bf16x2 (as in K1);
//   * fp32: an m16n8k8 tf32 A fragment wants keys t and t + 4 where a lane
//     holds keys 2t and 2t + 1, so the PV product runs its k axis in the
//     order (0, 2, 4, 6, 1, 3, 5, 7) of each 8 keys: a0..a3 are c0, c2,
//     c1, c3 of the accumulator, and the V fragment is read in the same
//     order. A sum does not care about the order.
// K and V stream through a ring of key tiles in shared memory (3 stages in
// bf16, 2 in fp32), filled with 16-byte `cp.async` copies while the warps
// compute on an earlier stage; keys at or past kv_len are zero-filled by
// the copy (src-size 0) and masked to -inf in S, so a key past Lkv never
// reaches l. D that is not whole 16-byte units (or a misaligned pointer)
// takes plain loads into the same ring. Rows are padded to DP = the
// supported width >= D; the pad columns are zeroed once and QK^T runs over
// them (exact zeros); PV skips the n8 tiles past D. Row strides: bf16 DP +
// 8 (an odd multiple of 16 bytes, so `ldmatrix`, `.trans` for V, is free
// of bank conflicts); fp32 DP + 4 words (the scalar fragment loads of a
// warp fall on 32 distinct banks). Key tiles are 64 keys up to DP = 128,
// 32 above (D = 160 holds 80 fp32 accumulators a thread, D = 256 128); Q
// fragments stay in registers up to DP = 160 in bf16 and are read from
// shared memory per tile above that, and in fp32 (split on the fly).
//
// Bounds on the H100: at D = 40 each logit carries 3 x 2 x 48 = 288
// tensor-core FLOPs (QK^T, PV hi and lo) and one ex2; the MUFU's 16 ex2 a
// clock an SM binds before the bf16 tensor cores do. At Lkv = 77 the
// bytes of q and o bind.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "sm90_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

template <int DP, typename T>
struct Cfg {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int BK = DP <= 128 ? 64 : 32;      // keys a tile
  static constexpr int kStages = kBf16 ? 3 : 2;
  static constexpr int ld = DP + (kBf16 ? 8 : 4);     // row stride, elements
  static constexpr int tile = BK * ld;                // one K or V tile
  static size_t bytes(int warps) {
    return sizeof(T) * (static_cast<size_t>(warps) * 16 * ld + 2ull * kStages * tile);
  }
};

// d (16x8 fp32) += a (16x8 tf32, row) . b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 3xTF32: d += a . b with a = ab + as, b = bb + bs (the small terms first).
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0,
                                           uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// bf16x2 of (lo, hi) and of their residuals: x = bf16(x) + bf16(x - bf16(x)) + O(2^-17 x).
__device__ __forceinline__ void split_bf16x2(float lo, float hi, uint32_t& big,
                                             uint32_t& small) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  const float2 bf = __bfloat1622float2(b);
  const __nv_bfloat162 s = __floats2bfloat162_rn(lo - bf.x, hi - bf.y);
  big = *reinterpret_cast<const uint32_t*>(&b);
  small = *reinterpret_cast<const uint32_t*>(&s);
}


// One key tile of K and V (keys k0 .. k0 + BK) into a ring stage. Keys at
// or past kv_len are zero. Columns >= D are not touched (zeroed once). The
// vector path walks the 16-byte units of a padded row (a constant count,
// so no runtime division) and skips those past D.
template <int DP, typename T>
__device__ __forceinline__ void load_kv(T* ks, T* vs, const T* kh, const T* vh, int k0,
                                        int kv_len, int D, bool vec) {
  constexpr int ld = Cfg<DP, T>::ld, BK = Cfg<DP, T>::BK;
  constexpr int kPer16 = 16 / sizeof(T);
  constexpr int kUnits = DP / kPer16;  // 16-byte units of a padded row
  if (vec) {
    for (int i = threadIdx.x; i < BK * kUnits; i += blockDim.x) {
      const int r = i / kUnits, c = (i - r * kUnits) * kPer16;
      if (c >= D) continue;
      const bool ok = k0 + r < kv_len;
      const size_t g = ok ? static_cast<size_t>(k0 + r) * D + c : 0;
      cp_async16(ks + r * ld + c, kh + g, ok ? 16 : 0);
      cp_async16(vs + r * ld + c, vh + g, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < BK * D; i += blockDim.x) {
      const int r = i / D, c = i - r * D;
      T kx = T(0.f), vx = T(0.f);
      if (k0 + r < kv_len) {
        const size_t g = static_cast<size_t>(k0 + r) * D + c;
        kx = kh[g];
        vx = vh[g];
      }
      ks[r * ld + c] = kx;
      vs[r * ld + c] = vx;
    }
  }
}

// Everything before the key loop: zero the pad columns of every ring stage
// (the loads never write them), load the block's q rows (rows past Lq and
// columns past D zero) and put the first kStages - 1 tiles in flight.
template <int DP, typename T>
__device__ __forceinline__ void prologue(T* qs, T* kv, const T* q, const T* kh, const T* vh,
                                         int q0, int Lq, int kv_len, int D, bool vec) {
  using C = Cfg<DP, T>;
  constexpr int ld = C::ld;
  constexpr int kPer16 = 16 / sizeof(T);
  const int bq = blockDim.x / 2;  // 16 rows a warp
  if (D < DP)  // the columns that QK^T and PV read past D
    for (int r = threadIdx.x; r < 2 * C::kStages * C::BK; r += blockDim.x)
      for (int c = D; c < DP; ++c) kv[r * ld + c] = T(0.f);
  if (vec) {  // whole 16-byte units, zero past D and past Lq
    for (int i = threadIdx.x; i < bq * (DP / kPer16); i += blockDim.x) {
      const int r = i / (DP / kPer16), c = (i - r * (DP / kPer16)) * kPer16;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (c < D && q0 + r < Lq)
        x = *reinterpret_cast<const uint4*>(q + static_cast<size_t>(q0 + r) * D + c);
      *reinterpret_cast<uint4*>(qs + r * ld + c) = x;
    }
  } else {
    for (int i = threadIdx.x; i < bq * DP; i += blockDim.x) {
      const int r = i / DP, c = i - r * DP;
      qs[r * ld + c] = (c < D && q0 + r < Lq) ? q[static_cast<size_t>(q0 + r) * D + c] : T(0.f);
    }
  }
  __syncthreads();  // pads are zero before any cp.async lands beside them
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s * C::BK < kv_len)
      load_kv<DP, T>(kv + 2 * s * C::tile, kv + (2 * s + 1) * C::tile, kh, vh, s * C::BK,
                     kv_len, D, vec);
    cp_async_commit();
  }
}

// Wait for tile t, then put tile t + kStages - 1 in flight into the stage
// that tile t - 1 used. Returns tile t's K stage (V follows it).
template <int DP, typename T>
__device__ __forceinline__ const T* next_tile(T* kv, const T* kh, const T* vh, int t,
                                              int ntiles, int kv_len, int D, bool vec) {
  using C = Cfg<DP, T>;
  cp_async_wait<C::kStages - 2>();
  __syncthreads();  // tile t has landed for every thread; stage (t - 1) is free
  const int nt = t + C::kStages - 1;
  if (nt < ntiles) {
    const int s = nt % C::kStages;
    load_kv<DP, T>(kv + 2 * s * C::tile, kv + (2 * s + 1) * C::tile, kh, vh, nt * C::BK,
                   kv_len, D, vec);
  }
  cp_async_commit();
  return kv + 2 * (t % C::kStages) * C::tile;
}

// The online-softmax step on one tile's S accumulators (rows lane/4 and
// lane/4 + 8): mask keys >= kv_len, update the running max of the scaled
// logits (a quad reduces), rescale l and acc, and leave the scaled logits
// minus the new max in sc for the exp.
template <int NJ, int NT>
__device__ __forceinline__ void softmax_step(float (&sc)[NJ][4], float (&acc)[NT][4],
                                             float (&m)[2], float (&l)[2], int k0,
                                             int kv_len, float qk_scale) {
  const int lane = threadIdx.x % 32;
  if (k0 + NJ * 8 > kv_len) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = k0 + j * 8 + (lane % 4) * 2;
      if (col >= kv_len) sc[j][0] = sc[j][2] = -INFINITY;
      if (col + 1 >= kv_len) sc[j][1] = sc[j][3] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
  }
  float c[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * qk_scale);  // finite: key k0 is valid
    c[h] = fast_exp2(m[h] - m_new);
    m[h] = m_new;
    l[h] *= c[h];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] *= c[0];
    acc[n][1] *= c[0];
    acc[n][2] *= c[1];
    acc[n][3] *= c[1];
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    sc[j][0] = fmaf(sc[j][0], qk_scale, -m[0]);
    sc[j][1] = fmaf(sc[j][1], qk_scale, -m[0]);
    sc[j][2] = fmaf(sc[j][2], qk_scale, -m[1]);
    sc[j][3] = fmaf(sc[j][3], qk_scale, -m[1]);
  }
}

// o = acc / max(l, 1e-30) for rows lane/4 and lane/4 + 8 of the warp's tile.
template <int NT, typename T>
__device__ __forceinline__ void epilogue(T* o, const float (&acc)[NT][4], float (&l)[2],
                                         int row0, int Lq, int D) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + lane / 4 + 8 * h;
    if (row >= Lq) continue;
    const float r = 1.f / fmaxf(l[h], 1e-30f);
    T* orow = o + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + (lane % 4) * 2;
      if (c + 1 < D && D % 2 == 0) {
        store_f2(orow + c, acc[n][2 * h] * r, acc[n][2 * h + 1] * r);
      } else {
        if (c < D) store_f(orow + c, acc[n][2 * h] * r);
        if (c + 1 < D) store_f(orow + c + 1, acc[n][2 * h + 1] * r);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(256)
flash_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int Lq, int Lkv,
                     int kv_len, int D, float qk_scale, int vec) {
  using C = Cfg<DP, bf16>;
  constexpr int BK = C::BK, ld = C::ld;
  constexpr int KS = DP / 16;           // k16 steps of QK^T
  constexpr int NT = DP / 8;            // n8 tiles of the output (those past D skipped)
  constexpr bool kQReg = DP <= 160;     // Q fragments held in registers
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kv = qs + (blockDim.x / 2) * ld;  // stage s: K at kv + 2s·tile, V after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * (blockDim.x / 2);
  const bf16* kh = k + static_cast<size_t>(blockIdx.y) * Lkv * D;
  const bf16* vh = v + static_cast<size_t>(blockIdx.y) * Lkv * D;
  const int ntiles = (kv_len + BK - 1) / BK;
  prologue<DP, bf16>(qs, kv, q + static_cast<size_t>(blockIdx.y) * Lq * D, kh, vh, q0, Lq,
                     kv_len, D, vec);

  // ldmatrix lane offsets: Q (A, 16 x 16), K (B, non-transposed), V (B, .trans)
  const bf16* qw = qs + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ld + (lane / 16) * 8;
  const int k_off = ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
  const int v_off = ((lane % 8) + ((lane / 8) % 2) * 8) * ld + (lane / 16) * 8;
  uint32_t qa[kQReg ? KS : 1][4];
  if constexpr (kQReg) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(qa[kk], qw + kk * 16);
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const bf16* ks = next_tile<DP, bf16>(kv, kh, vh, t, ntiles, kv_len, D, vec);
    const bf16* vs = ks + C::tile;

    // S (16 x BK) = Q . K_tile^T in BK/8 n8 accumulator tiles (raw logits)
    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (kQReg) {
        a[0] = qa[kk][0], a[1] = qa[kk][1], a[2] = qa[kk][2], a[3] = qa[kk][3];
      } else {
        ldsm_x4(a, qw + kk * 16);
      }
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, ks + jp * 16 * ld + kk * 16 + k_off);
        mma_bf16(sc[2 * jp], a, b[0], b[1]);
        mma_bf16(sc[2 * jp + 1], a, b[2], b[3]);
      }
    }
    softmax_step<BK / 8, NT>(sc, acc, m, l, t * BK, kv_len, qk_scale);

    // P = ex2(.) in the accumulators, split into bf16 hi + lo A fragments
    // (16 keys a k16 step); O (16 x D) += P_hi . V + P_lo . V.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* s = sc[2 * kk + e];
        const float p0 = fast_exp2(s[0]), p1 = fast_exp2(s[1]);
        const float p2 = fast_exp2(s[2]), p3 = fast_exp2(s[3]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        split_bf16x2(p0, p1, hi[2 * e], lo[2 * e]);
        split_bf16x2(p2, p3, hi[2 * e + 1], lo[2 * e + 1]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const bf16* vp = vs + kk * 16 * ld + np * 16 + v_off;
        if (np * 16 + 8 < D) {
          uint32_t b[4];
          ldsm_x4_t(b, vp);
          mma_bf16(acc[2 * np], hi, b[0], b[1]);
          mma_bf16(acc[2 * np], lo, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
          mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
        } else if (np * 16 < D) {
          uint32_t b[2];
          ldsm_x2_t(b, vp);
          mma_bf16(acc[2 * np], hi, b[0], b[1]);
          mma_bf16(acc[2 * np], lo, b[0], b[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  epilogue<NT>(o + static_cast<size_t>(blockIdx.y) * Lq * D, acc, l, q0 + warp * 16, Lq, D);
}

template <int DP>
__global__ void __launch_bounds__(256)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int Lq, int Lkv,
                    int kv_len, int D, float qk_scale, int vec) {
  using C = Cfg<DP, float>;
  constexpr int BK = C::BK, ld = C::ld;
  constexpr int KS = DP / 8;   // k8 steps of QK^T
  constexpr int NT = DP / 8;   // n8 tiles of the output (those past D skipped)
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* kv = qs + (blockDim.x / 2) * ld;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int q0 = blockIdx.x * (blockDim.x / 2);
  const float* kh = k + static_cast<size_t>(blockIdx.y) * Lkv * D;
  const float* vh = v + static_cast<size_t>(blockIdx.y) * Lkv * D;
  const int ntiles = (kv_len + BK - 1) / BK;
  prologue<DP, float>(qs, kv, q + static_cast<size_t>(blockIdx.y) * Lq * D, kh, vh, q0, Lq,
                      kv_len, D, vec);
  const float* qw = qs + (warp * 16 + g) * ld + tq;  // A: rows g, g + 8; columns t, t + 4

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const float* ks = next_tile<DP, float>(kv, kh, vh, t, ntiles, kv_len, D, vec);
    const float* vs = ks + C::tile;

    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < KS; ++kk) {
      const float* qp = qw + kk * 8;
      uint32_t ab[4], as[4];
      split_tf32(qp[0], ab[0], as[0]);
      split_tf32(qp[8 * ld], ab[1], as[1]);
      split_tf32(qp[4], ab[2], as[2]);
      split_tf32(qp[8 * ld + 4], ab[3], as[3]);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float* kp = ks + (j * 8 + g) * ld + kk * 8 + tq;  // B: key g, columns t, t + 4
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(kp[0], bb0, bs0);
        split_tf32(kp[4], bb1, bs1);
        mma_3xtf32(sc[j], ab, as, bb0, bb1, bs0, bs1);
      }
    }
    softmax_step<BK / 8, NT>(sc, acc, m, l, t * BK, kv_len, qk_scale);

    // P = ex2(.) per 8-key tile j, in the k order (0, 2, 4, 6, 1, 3, 5, 7):
    // A = (c0, c2, c1, c3), V rows 2t and 2t + 1 as b0 and b1.
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = fast_exp2(sc[j][0]), p1 = fast_exp2(sc[j][1]);
      const float p2 = fast_exp2(sc[j][2]), p3 = fast_exp2(sc[j][3]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      uint32_t ab[4], as[4];
      split_tf32(p0, ab[0], as[0]);
      split_tf32(p2, ab[1], as[1]);
      split_tf32(p1, ab[2], as[2]);
      split_tf32(p3, ab[3], as[3]);
      const float* vp = vs + (j * 8 + 2 * tq) * ld + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n * 8 < D) {
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(vp[n * 8], bb0, bs0);
          split_tf32(vp[n * 8 + ld], bb1, bs1);
          mma_3xtf32(acc[n], ab, as, bb0, bb1, bs0, bs1);
        }
      }
    }
  }
  cp_async_wait<0>();
  epilogue<NT>(o + static_cast<size_t>(blockIdx.y) * Lq * D, acc, l, q0 + warp * 16, Lq, D);
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int Lq, int Lkv,
           int kv_len, int D, float qk_scale, int warps, int vec, cudaStream_t stream) {
  const size_t bytes = Cfg<DP, T>::bytes(warps);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = [] {
    if constexpr (sizeof(T) == 2) return flash_attention_bf16<DP>;
    else return flash_attention_f32<DP>;
  }();
  static size_t attr_bytes = 0;  // one host thread launches; raised once per size
  if (bytes > attr_bytes) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_bytes = bytes;
  }
  const int bq = 16 * warps;
  const dim3 grid((Lq + bq - 1) / bq, bh);
  kernel<<<grid, 32 * warps, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Lq, Lkv, kv_len, D, qk_scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int Lq, int Lkv,
             int kv_len, int D, float qk_scale, int warps, int vec, cudaStream_t s) {
#define K3_LAUNCH(DP) launch<DP, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, qk_scale, warps, vec, s)
  // DP: the smallest supported width that holds D
  if (D <= 16) return K3_LAUNCH(16);
  if (D <= 32) return K3_LAUNCH(32);
  if (D <= 48) return K3_LAUNCH(48);
  if (D <= 64) return K3_LAUNCH(64);
  if (D <= 80) return K3_LAUNCH(80);
  if (D <= 96) return K3_LAUNCH(96);
  if (D <= 128) return K3_LAUNCH(128);
  if (D <= 160) return K3_LAUNCH(160);
  if (D <= 192) return K3_LAUNCH(192);
  return K3_LAUNCH(256);
#undef K3_LAUNCH
}

}  // namespace

// q, o: contiguous (bh, Lq, D); k, v: contiguous (bh, Lkv, D); all bf16
// (is_bf16 = 1) or all fp32. Keys at index >= kv_len are masked;
// 1 <= kv_len <= Lkv, 1 <= D <= 256. A block has `warps` warps (1, 2, 4 or
// 8), each owning 16 q rows. Returns a cudaError_t value (0 on success).
extern "C" int anyedit_flash_attention(const void* q, const void* k, const void* v,
                                       void* o, int bh, int Lq, int Lkv, int kv_len,
                                       int D, float scale, int is_bf16, int warps,
                                       void* stream) {
  if (bh < 1 || bh > 65535 || Lq < 1 || Lkv < 1 || kv_len < 1 || kv_len > Lkv ||
      D < 1 || D > 256 || (warps != 1 && warps != 2 && warps != 4 && warps != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = D % (is_bf16 ? 8 : 4) == 0 && aligned(q) && aligned(k) && aligned(v);
  const float qk_scale = scale * 1.4426950408889634f;  // logits in base 2
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<bf16>(q, k, v, o, bh, Lq, Lkv, kv_len, D, qk_scale, warps, vec, s);
  return dispatch<float>(q, k, v, o, bh, Lq, Lkv, kv_len, D, qk_scale, warps, vec, s);
}
