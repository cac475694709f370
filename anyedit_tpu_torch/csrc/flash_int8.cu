// K4: online-softmax attention with int8 tensor-core products, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `anyedit_tpu/ops/attention.py::_flash_int8_kernel`
// (wrappers `flash_int8`, `_self_attn_int8`) and the quantization that the
// JAX wrapper does in XLA ops. `anyedit_k4_quantize` takes k's absmax per
// tensor and v's per (head, channel) (`k4_absmax`, integer atomics on the
// bits of non-negative floats) and writes the int8 codes in this kernel's
// layout (`k4_quantize`, described below; `ops/attention.py::k4_layout` is
// its reference): sk = max(absmax, 1e-8) / 127, k8 = clip(rint(k / sk),
// +-127), the same for v per channel. `anyedit_flash_int8` quantizes q per
// row and keeps the JAX kernel's order of operations over its key blocks
// of `block_k` keys (512 by default, as in the JAX package; the last block
// is cut at kv_len), with fac = sk * softmax_scale:
//   sq  = max(absmax(q_row), 1e-8) / 127,  q8 = rint(q / sq)      (|q8| <= 127)
//   for each key block:
//     s32 = q8 k8^T (int32),  s = float(s32) * (sq * fac),  s = -inf at col >= kv_len
//     m_new = max(m, rowmax(s) over the whole block),  p = exp(s - m_new) in (0, 1]
//     p8 = rint(p * 127),  pv = p8 v8 (one int32 product over the block)
//     c = exp(m - m_new),  l = l * c + rowsum(p)   (the unrounded p)
//     acc = acc * c + float(pv)
//   o = acc * (sv / 127) / max(l, 1e-30)
// Rounding points: q8 and p8 round half to even (`__float2int_rn` for q8;
// p8 = the low byte of fp32(127 p) + 1.5 * 2^23, whose fp32 addition
// rounds half to even as jnp.round does). p8 depends on the running max of
// its block, so the result depends on the block size; the plain version
// (`flash_int8_plain`) walks the same blocks. The exp runs in base 2 and
// carries the 127 of the grid: 127 p = ex2(s * log2(e) + log2(127) - m)
// (`ex2.approx`, one FFMA and one MUFU op a logit), and l sums 127 p, so
// the output divides by l / 127. Against the plain version's exp and
// multiply that is a few fp32 roundings, which move the odd p8 code by one.
// int32 S converts to fp32 exactly by the same 1.5 * 2^23 trick (|s32| <=
// 127 * 127 * 128 < 2^22), so neither per-logit conversion is a conversion
// instruction (16 a clock an SM on compute capability 9.0, the exp's rate);
// the block's P.V (< 127 * 127 * 512 < 2^23) converts once per block.
//
// Design. A warp owns one m16 tile of q rows and quantizes them in a
// prologue (row absmax by warp shuffles); the q8 A fragments stay in
// registers for the whole kernel. Both products are `mma.sync` on int8
// (`m16n8k32`, with an `m16n8k16` step where round16(D) is 16 past a
// multiple of 32: D = 40 and 80), int32 accumulators. Each block of keys
// takes two passes over its 64-key sub-tiles: pass 1 runs QK^T and keeps
// only the int32 row max (row_f = sq * fac > 0, so the max is taken on the
// int32 values and scaled once); pass 2 runs QK^T again and takes exp, p8,
// the row sums and P.V into a block-wide int32 accumulator, all in
// registers. Neither S, P8 nor P.V touches shared memory. The second QK^T
// is the price of the block's max; the exp count does not change.
// Two layout hazards, and the answers chosen here:
//   * the int8 B operand is k-major and `ldmatrix .trans` moves only 16-bit
//     elements, so V reaches the kernel transposed: `k4_quantize` writes
//     v8ᵀ (bh, DP, LP) as it quantizes;
//   * an m16n8 accumulator gives a lane 2 adjacent keys of each n8 tile
//     (2t, 2t + 1, and 8 + 2t, 9 + 2t of 16), while an int8 A register holds
//     4 adjacent k. `k4_quantize` applies one fixed key order inside each
//     32-key group of v8ᵀ (`key_order`), the order in which the lane
//     already holds P: four p8 bytes pack into an A register with `prmt`,
//     and no shuffle moves P between lanes. A sum does not care about order.
// k8 and v8ᵀ are also padded with zeros to DP = round16(D) (40 -> 48: a
// zero column changes no product and no absmax) and to LP = round64(L)
// keys (masked), so every K row and every V row of a tile is whole 16-byte
// units: K and V stream through a 3-stage ring of 16-byte `cp.async`
// copies (pass 1 loads K only). Row strides in shared memory are odd
// multiples of 16 bytes, so `ldmatrix` is free of bank conflicts.
//
// Bounds on the H100: at D = 40 each logit carries 2 x 2 x 48 int8 ops of
// QK^T (two passes) and 2 x 48 of P.V, and one ex2; the MUFU's 16 ex2 a
// clock an SM bind far before the int8 tensor cores do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <climits>
#include <cstdint>

#include "sm90_ptx.cuh"

namespace {

constexpr int kTile = 64;   // keys a sub-tile
constexpr int kStages = 3;
constexpr int kMaxSmem = 232448;
constexpr float kMagic = 12582912.f;       // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;     // its bits
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLog2_127 = 6.988684686772166f;

template <int DP>
struct Lay {
  static constexpr int ldk = (DP / 16) % 2 ? DP : DP + 16;  // q8 / k8 rows, bytes
  static constexpr int ldv = kTile + 16;                    // v8ᵀ rows, bytes
  static constexpr int ktile = kTile * ldk;
  static constexpr int stage = ktile + DP * ldv;
  static size_t bytes(int warps) {
    return static_cast<size_t>(warps) * 16 * ldk + static_cast<size_t>(kStages) * stage;
  }
};

// d (16x8 s32) += a (16x32 s8, row) . b (32x8 s8, col)
__device__ __forceinline__ void mma_k32(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d (16x8 s32) += a (16x16 s8, row) . b (16x8 s8, col)
__device__ __forceinline__ void mma_k16(int (&d)[4], const uint32_t (&a)[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// Exact int -> fp32 for |x| < 2^22, on the FMA pipe.
__device__ __forceinline__ float i2f_small(int x) {
  return __int_as_float(x + kMagicBits) - kMagic;
}
// x + 1.5 * 2^23: its low byte is rint(x) for x in [0, 127].
__device__ __forceinline__ uint32_t p8_bits(float x) {
  return __float_as_uint(__fadd_rn(x, kMagic));
}
// The low bytes of four such words, first in the lowest byte.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// One item of the key stream into a ring stage: 64 keys of k8 and, for the
// P.V pass, the same keys of v8ᵀ (DP channel rows of 64 bytes).
template <int DP>
__device__ __forceinline__ void load_item(unsigned char* st, const int8_t* kh, const int8_t* vh,
                                          int key0, bool pv, int LP) {
  using Y = Lay<DP>;
  constexpr int cpr = DP / 16;
  for (int i = threadIdx.x; i < kTile * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i - r * cpr) * 16;
    cp_async16(st + r * Y::ldk + c, kh + static_cast<size_t>(key0 + r) * DP + c);
  }
  if (pv)
    for (int i = threadIdx.x; i < DP * (kTile / 16); i += blockDim.x) {
      const int ch = i / (kTile / 16), c = (i % (kTile / 16)) * 16;
      cp_async16(st + Y::ktile + ch * Y::ldv + c, vh + static_cast<size_t>(ch) * LP + key0 + c);
    }
}

// The key stream: for each block, its sub-tiles once for pass 1 (max), then
// once more for pass 2 (P.V). Decodes item `it` into its first key and pass.
struct Stream {
  int block_k, nsub, nblk, last_sub;
  __device__ Stream(int kv_len, int bk) : block_k(bk), nsub(bk / kTile) {
    nblk = (kv_len + bk - 1) / bk;
    last_sub = (kv_len - (nblk - 1) * bk + kTile - 1) / kTile;
  }
  __device__ int items() const { return 2 * ((nblk - 1) * nsub + last_sub); }
  // sub: the sub-tile within its block; ns: the block's sub-tiles
  __device__ void decode(int it, int& key0, bool& pv, int& sub, int& ns) const {
    const int b = it / (2 * nsub);
    const int r = it - b * 2 * nsub;
    ns = b == nblk - 1 ? last_sub : nsub;
    pv = r >= ns;
    sub = pv ? r - ns : r;
    key0 = b * block_k + sub * kTile;
  }
};

// Position p of a 32-key group of v8ᵀ holds key 16 h + 2 t + 8 (i / 2) + i % 2,
// p = 16 h + 4 t + i (`ops/attention.py::_k4_key_order`).
__device__ __forceinline__ int key_order(int p) {
  return (p & 16) + 2 * ((p & 15) >> 2) + 8 * ((p & 3) >> 1) + (p & 1);
}
__device__ __forceinline__ float scale_of(int absmax_bits) {
  return fmaxf(__int_as_float(absmax_bits), 1e-8f) / 127.f;
}
__device__ __forceinline__ int8_t quantize(float x, float s) {
  return static_cast<int8_t>(max(-127, min(127, __float2int_rn(x / s))));
}

// absmax of k over everything (kmax) and of v per (head, channel) (vmax, bh
// x D), as the bits of non-negative floats, whose int order is their order;
// both zeroed before. One block per 64 keys of one head.
template <typename T>
__global__ void __launch_bounds__(128)
k4_absmax(const T* __restrict__ k, const T* __restrict__ v, int* __restrict__ kmax,
          int* __restrict__ vmax, int L, int D) {
  __shared__ int vs[128];
  __shared__ float ks[4];
  for (int c = threadIdx.x; c < D; c += blockDim.x) vs[c] = 0;
  __syncthreads();
  const int r0 = blockIdx.x * kTile;
  const size_t base = (static_cast<size_t>(blockIdx.y) * L + r0) * D;
  const int n = min(kTile, L - r0) * D;
  float km = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    km = fmaxf(km, fabsf(load_f(k + base + i)));
    atomicMax(&vs[i % D], __float_as_int(fabsf(load_f(v + base + i))));
  }
#pragma unroll
  for (int off = 16; off; off /= 2) km = fmaxf(km, __shfl_xor_sync(0xffffffffu, km, off));
  if (threadIdx.x % 32 == 0) ks[threadIdx.x / 32] = km;
  __syncthreads();
  if (threadIdx.x == 0)
    atomicMax(kmax, __float_as_int(fmaxf(fmaxf(ks[0], ks[1]), fmaxf(ks[2], ks[3]))));
  for (int c = threadIdx.x; c < D; c += blockDim.x)
    atomicMax(&vmax[blockIdx.y * D + c], vs[c]);
}

// k8 (bh, LP, DP) and v8ᵀ (bh, DP, LP), keys in `key_order`, zero past L
// and D. One block per 64 keys of one head.
template <int DP, typename T>
__global__ void __launch_bounds__(128)
k4_quantize(const T* __restrict__ k, const T* __restrict__ v, const int* __restrict__ kmax,
            const int* __restrict__ vmax, int8_t* __restrict__ k8, int8_t* __restrict__ v8t,
            int L, int LP, int D) {
  const int key0 = blockIdx.x * kTile;
  const T* kh = k + static_cast<size_t>(blockIdx.y) * L * D;
  const T* vh = v + static_cast<size_t>(blockIdx.y) * L * D;
  const float sk = scale_of(kmax[0]);
  for (int i = threadIdx.x; i < kTile * DP; i += blockDim.x) {
    const int key = key0 + i / DP, c = i % DP;
    k8[(static_cast<size_t>(blockIdx.y) * LP + key) * DP + c] =
        key < L && c < D ? quantize(load_f(kh + static_cast<size_t>(key) * D + c), sk) : 0;
  }
  for (int i = threadIdx.x; i < DP * kTile; i += blockDim.x) {
    const int ch = i / kTile, p = i % kTile;
    const int key = key0 + (p & 32) + key_order(p & 31);
    v8t[(static_cast<size_t>(blockIdx.y) * DP + ch) * LP + key0 + p] =
        key < L && ch < D
            ? quantize(load_f(vh + static_cast<size_t>(key) * D + ch),
                       scale_of(vmax[blockIdx.y * D + ch]))
            : 0;
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(256)
flash_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ v8t, const int* __restrict__ kmax,
                  const int* __restrict__ vmax, T* __restrict__ o, int L, int LP, int kv_len,
                  int D, float scale, int block_k) {
  using Y = Lay<DP>;
  constexpr int KS = DP / 32;                // k32 steps of QK^T
  constexpr bool kTail16 = DP % 32 == 16;    // then one k16 step
  constexpr int NT = DP / 8;                 // n8 channel tiles of P.V
  constexpr int NJ = kTile / 8;              // n8 key tiles of S
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  int8_t* qs = reinterpret_cast<int8_t*>(smem);
  unsigned char* ring = smem + warps * 16 * Y::ldk;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = blockIdx.x * warps * 16 + warp * 16;  // the warp's first q row
  const int8_t* kh = k8 + static_cast<size_t>(blockIdx.y) * LP * DP;
  const int8_t* vh = v8t + static_cast<size_t>(blockIdx.y) * DP * LP;
  const Stream stream(kv_len, block_k);
  const int nitems = stream.items();

  // The first kStages - 1 items in flight, then q8 while they land.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nitems) {
      int key0, sub, ns;
      bool pv;
      stream.decode(s, key0, pv, sub, ns);
      load_item<DP>(ring + s * Y::stage, kh, vh, key0, pv, LP);
    }
    cp_async_commit();
  }

  // q: per-row scale and int8 codes; each warp quantizes its own 16 rows.
  const T* qh = q + static_cast<size_t>(blockIdx.y) * L * D;
  float sq[2] = {1.f, 1.f};  // rows g and g + 8
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const T* qr = qh + static_cast<size_t>(row) * D;
    float amax = 0.f;
    if (row < L)
      for (int c = lane; c < D; c += 32) amax = fmaxf(amax, fabsf(load_f(qr + c)));
#pragma unroll
    for (int off = 16; off; off /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = fmaxf(amax, 1e-8f) / 127.f;
    if (r == g) sq[0] = s;
    if (r == g + 8) sq[1] = s;
    for (int c = lane; c < DP; c += 32)
      qs[(warp * 16 + r) * Y::ldk + c] = static_cast<int8_t>(
          row < L && c < D ? __float2int_rn(load_f(qr + c) / s) : 0);
  }
  __syncwarp();
  uint32_t qa[KS > 0 ? KS : 1][4], qt[2];
  {
    const int8_t* qw =
        qs + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * Y::ldk + (lane / 16) * 16;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(qa[kk], qw + kk * 32);
    if constexpr (kTail16) ldsm_x2(qt, qs + (warp * 16 + lane % 16) * Y::ldk + KS * 32);
  }
  const float f0 = scale_of(kmax[0]) * scale;  // fac = sk * softmax_scale
  const float rf[2] = {sq[0] * f0 * kLog2e, sq[1] * f0 * kLog2e};  // base-2 row factors

  // ldmatrix lane offsets: K rows (keys) and v8ᵀ rows (channels), 16 x 32 bytes
  const int k_off = ((lane % 8) + (lane / 16) * 8) * Y::ldk + ((lane / 8) % 2) * 16;
  const int v_off = ((lane % 8) + (lane / 16) * 8) * Y::ldv + ((lane / 8) % 2) * 16;

  float acc[NT][4];
  int pvb[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f, pvb[n][e] = 0;
  // m: running max of the base-2 logits; mb = log2(127) - m; l: sum of 127 p
  float m[2] = {-INFINITY, -INFINITY}, mb[2], l[2] = {0.f, 0.f}, c[2] = {0.f, 0.f};
  int imax[2] = {INT_MIN, INT_MIN};

  for (int it = 0; it < nitems; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // item `it` has landed for every thread; its stage - 1 is free
    {
      const int nt = it + kStages - 1;
      if (nt < nitems) {
        int key0, sub, ns;
        bool pv;
        stream.decode(nt, key0, pv, sub, ns);
        load_item<DP>(ring + (nt % kStages) * Y::stage, kh, vh, key0, pv, LP);
      }
      cp_async_commit();
    }
    int key0, sub, ns;
    bool pv;
    stream.decode(it, key0, pv, sub, ns);
    const unsigned char* ks = ring + (it % kStages) * Y::stage;
    const unsigned char* vs = ks + Y::ktile;

    // S (16 x 64, int32) = Q8 . K8_tile^T
    int s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, ks + jp * 16 * Y::ldk + kk * 32 + k_off);
        mma_k32(s[2 * jp], qa[kk], b[0], b[1]);
        mma_k32(s[2 * jp + 1], qa[kk], b[2], b[3]);
      }
    if constexpr (kTail16) {
#pragma unroll
      for (int jq = 0; jq < NJ / 4; ++jq) {
        uint32_t b[4];
        ldsm_x4(b, ks + (jq * 32 + lane) * Y::ldk + KS * 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) mma_k16(s[4 * jq + e], qt, b[e]);
      }
    }
    const bool edge = key0 + kTile > kv_len;

    if (!pv) {  // pass 1: the int32 row max of the block
      if (edge) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = key0 + j * 8 + 2 * tq;
          if (col >= kv_len) s[j][0] = s[j][2] = INT_MIN;
          if (col + 1 >= kv_len) s[j][1] = s[j][3] = INT_MIN;
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        imax[0] = max(imax[0], max(s[j][0], s[j][1]));
        imax[1] = max(imax[1], max(s[j][2], s[j][3]));
      }
      continue;
    }

    if (sub == 0) {  // pass 2 begins: the block's max, the rescale of l
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        imax[h] = max(imax[h], __shfl_xor_sync(0xffffffffu, imax[h], 1));
        imax[h] = max(imax[h], __shfl_xor_sync(0xffffffffu, imax[h], 2));
        const float m_new = fmaxf(m[h], i2f_small(imax[h]) * rf[h]);  // the block holds a valid key
        c[h] = fast_exp2(m[h] - m_new);
        m[h] = m_new;
        mb[h] = kLog2_127 - m_new;
        l[h] *= c[h];
        imax[h] = INT_MIN;
      }
    }

    // 127 p = ex2(s * rf + log2(127) - m), p8 packed into int8 A fragments
    // (32 keys each, in `_k4_key_order`), P8 . V8 into the block's int32
    // accumulator.
#pragma unroll
    for (int u = 0; u < NJ / 4; ++u) {
      uint32_t w[4][4];  // p8 words of the 4 key tiles of this 32-key group
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * u + jj;
        const int col = key0 + j * 8 + 2 * tq;
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = fast_exp2(fmaf(i2f_small(s[j][e]), rf[e / 2], mb[e / 2]));
          if (edge && col + (e % 2) >= kv_len) p[e] = 0.f;
          w[jj][e] = p8_bits(p[e]);
        }
        l[0] += p[0] + p[1];
        l[1] += p[2] + p[3];
      }
      uint32_t a[4];
      a[0] = pack4(w[0][0], w[0][1], w[1][0], w[1][1]);  // row g, keys 2t, 2t+1, 8+2t, 9+2t
      a[1] = pack4(w[0][2], w[0][3], w[1][2], w[1][3]);  // row g + 8
      a[2] = pack4(w[2][0], w[2][1], w[3][0], w[3][1]);  // row g, the next 16 keys
      a[3] = pack4(w[2][2], w[2][3], w[3][2], w[3][3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, vs + np * 16 * Y::ldv + u * 32 + v_off);
        mma_k32(pvb[2 * np], a, b[0], b[1]);
        mma_k32(pvb[2 * np + 1], a, b[2], b[3]);
      }
    }

    if (sub == ns - 1) {  // the block's end: acc = acc * c + float(pv)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[n][e] = __fadd_rn(__fmul_rn(acc[n][e], c[e / 2]), __int2float_rn(pvb[n][e]));
          pvb[n][e] = 0;
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const int* svh = vmax + static_cast<size_t>(blockIdx.y) * D;
  T* oh = o + static_cast<size_t>(blockIdx.y) * L * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= L) continue;
    const float denom = fmaxf(l[h] / 127.f, 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * tq + e;
        if (col < D)
          store_f(oh + static_cast<size_t>(row) * D + col,
                  acc[n][2 * h + e] * (scale_of(svh[col]) / 127.f) / denom);
      }
  }
}

template <int DP, typename T>
int launch_quantize(const void* k, const void* v, int* kmax, void* k8, void* v8t, int bh,
                    int L, int LP, int D, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(kmax, 0, sizeof(int) * (1 + static_cast<size_t>(bh) * D),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  k4_absmax<T><<<dim3((L + kTile - 1) / kTile, bh), 128, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), kmax, kmax + 1, L, D);
  k4_quantize<DP, T><<<dim3(LP / kTile, bh), 128, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), kmax, kmax + 1,
      static_cast<int8_t*>(k8), static_cast<int8_t*>(v8t), L, LP, D);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, typename T>
int launch(const void* q, const void* k8, const void* v8t, const int* kmax, void* o, int bh,
           int L, int LP, int kv_len, int D, float scale, int block_k, int warps,
           cudaStream_t stream) {
  const size_t bytes = Lay<DP>::bytes(warps);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static size_t attr_bytes = 0;  // one host thread launches; raised once per size
  if (bytes > attr_bytes) {
    cudaError_t err = cudaFuncSetAttribute(flash_int8_kernel<DP, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_bytes = bytes;
  }
  const int bq = 16 * warps;
  const dim3 grid((L + bq - 1) / bq, bh);
  flash_int8_kernel<DP, T><<<grid, 32 * warps, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8t), kmax, kmax + 1, static_cast<T*>(o), L, LP, kv_len, D,
      scale, block_k);
  return static_cast<int>(cudaGetLastError());
}

// K4_LAUNCH(DP): the launch of the dispatching function at width DP.
#define K4_DISPATCH(D, K4_LAUNCH)     \
  switch (((D) + 15) / 16) {          \
    case 1: return K4_LAUNCH(16);     \
    case 2: return K4_LAUNCH(32);     \
    case 3: return K4_LAUNCH(48);     \
    case 4: return K4_LAUNCH(64);     \
    case 5: return K4_LAUNCH(80);     \
    case 6: return K4_LAUNCH(96);     \
    case 7: return K4_LAUNCH(112);    \
    default: return K4_LAUNCH(128);   \
  }

template <typename T>
int dispatch_quantize(const void* k, const void* v, int* kmax, void* k8, void* v8t, int bh,
                      int L, int LP, int D, cudaStream_t s) {
#define K4_LAUNCH(DP) launch_quantize<DP, T>(k, v, kmax, k8, v8t, bh, L, LP, D, s)
  K4_DISPATCH(D, K4_LAUNCH)
#undef K4_LAUNCH
}

template <typename T>
int dispatch(const void* q, const void* k8, const void* v8t, const int* kmax, void* o, int bh,
             int L, int LP, int kv_len, int D, float scale, int block_k, int warps,
             cudaStream_t s) {
#define K4_LAUNCH(DP) \
  launch<DP, T>(q, k8, v8t, kmax, o, bh, L, LP, kv_len, D, scale, block_k, warps, s)
  K4_DISPATCH(D, K4_LAUNCH)
#undef K4_LAUNCH
}

}  // namespace

// k, v: contiguous (bh, L, D), bf16 (is_bf16 = 1) or fp32, 1 <= D <= 128;
// scratch: bh * D + 1 int32; k8: int8 (bh, LP, DP), v8t: int8 (bh, DP, LP),
// DP = round16(D), LP = round64(L). Writes the absmaxes into scratch and
// the codes in K4's layout (`ops/attention.py::k4_layout`). Returns a
// cudaError_t value (0 on success).
extern "C" int anyedit_k4_quantize(const void* k, const void* v, void* scratch, void* k8,
                                   void* v8t, int bh, int L, int LP, int D, int is_bf16,
                                   void* stream) {
  if (bh < 1 || bh > 65535 || L < 1 || LP % kTile != 0 || LP < L || D < 1 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* kmax = static_cast<int*>(scratch);
  if (is_bf16)
    return dispatch_quantize<__nv_bfloat16>(k, v, kmax, k8, v8t, bh, L, LP, D, s);
  return dispatch_quantize<float>(k, v, kmax, k8, v8t, bh, L, LP, D, s);
}

// q, o: contiguous (bh, L, D), bf16 (is_bf16 = 1) or fp32; k8, v8t and
// scratch as `anyedit_k4_quantize` wrote them for the same k, v. Keys at
// index >= kv_len are masked; 1 <= kv_len <= L, 1 <= D <= 128, block_k a
// positive multiple of 64, warps 1, 2, 4 or 8 (16 q rows each). Returns a
// cudaError_t value (0 on success).
extern "C" int anyedit_flash_int8(const void* q, const void* k8, const void* v8t,
                                  const void* scratch, void* o, int bh, int L, int LP,
                                  int kv_len, int D, float scale, int block_k, int is_bf16,
                                  int warps, void* stream) {
  if (bh < 1 || bh > 65535 || L < 1 || LP % kTile != 0 || LP < L || kv_len < 1 ||
      kv_len > L || D < 1 || D > 128 || block_k < kTile || block_k % kTile != 0 ||
      (warps != 1 && warps != 2 && warps != 4 && warps != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* kmax = static_cast<const int*>(scratch);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k8, v8t, kmax, o, bh, L, LP, kv_len, D, scale, block_k,
                                   warps, s);
  return dispatch<float>(q, k8, v8t, kmax, o, bh, L, LP, kv_len, D, scale, block_k, warps, s);
}
