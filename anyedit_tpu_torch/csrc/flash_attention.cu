// K3: online-softmax attention in fp32 for Hopper (sm_90a), any Lq / Lkv.
//
// Replaces the TPU kernel `anyedit_tpu/ops/attention.py::_flash_kernel`
// (wrapper `flash_attention`). Same arithmetic, all of it in fp32:
//   q' = fp32(q) * scale;  k, v upcast to fp32
//   for each key tile:  s = q' k^T,  s = -inf where col >= kv_len,
//     m_new = max(m, rowmax(s)),  p = exp(s - m_new),  c = exp(m - m_new),
//     l = l * c + rowsum(p),  acc = acc * c + p v,  m = m_new
//   o = acc / max(l, 1e-30), cast to q's dtype.
// The running max starts at -inf and the first key tile always holds a
// valid key (kv_len >= 1), so exp(m - m_new) never sees -inf - (-inf); tiles
// past kv_len are never visited.
//
// The TPU kernel runs both contractions in fp32 on the MXU. Hopper's tensor
// cores have no fp32 mode (TF32 keeps 10 mantissa bits and would miss the
// 2e-5 fp32 bound), so this kernel does every product with FFMA on the CUDA
// cores. That bounds it by FFMA throughput and shared-memory reads, not by
// tensor-core FLOPs: it is cheap at the cross-attention sizes (Lkv = 77) and
// slow at long self-attention, where the UNet's default route takes K1.
//
// Design: one block of 128 threads per (head, BQ-row q tile); the 128
// threads form 16 row groups x 8 column groups. A thread owns RQ q rows:
// for S it computes RQ x CK logits (key columns cg + 8j), for the output
// RQ x DP/8 accumulators (head columns cg + 8j). The row statistics live
// in the 8 lanes of one row group and reduce with warp shuffles. Q (scaled),
// K and V tiles sit in shared memory as fp32, D zero-padded to DP (a
// multiple of 8; exact); P goes through shared memory to the PV product.
// D <= 96 uses 64 x 64 tiles, larger D (160 in the UNet) 32 x 32 tiles to
// keep registers and shared memory in bounds. Left for later: bf16 MMA for
// the bf16 case with a split p, cp.async double buffering, wider tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DP>
struct Cfg {
  static constexpr int RQ = DP > 96 ? 2 : 4;   // q rows per thread
  static constexpr int CK = DP > 96 ? 4 : 8;   // key columns per thread
  static constexpr int BQ = 16 * RQ;
  static constexpr int BK = 8 * CK;
  // Q and K rows are read as float4 along d; a row stride of DP + 4 floats
  // (an odd number of 16-byte units) puts the 8 column groups' K rows on
  // distinct bank groups.
  static constexpr int LDQ = DP + 4;
  static constexpr int LDV = DP;
  static constexpr int LDP = BK + 1;           // the 4 row groups of a warp on distinct banks
  static constexpr size_t bytes = 4ull * (BQ * LDQ + BK * LDQ + BK * LDV + BQ * LDP);
};

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Lq, int Lkv,
                       int kv_len, int D, float scale) {
  using C = Cfg<DP>;
  constexpr int RQ = C::RQ, CK = C::CK, BQ = C::BQ, BK = C::BK, DJ = DP / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + BQ * C::LDQ;
  float* vs = ks + BK * C::LDQ;
  float* ps = vs + BK * C::LDV;

  const int tid = threadIdx.x;
  const int cg = tid & 7;      // column group: 8 consecutive lanes share a row group
  const int rg = tid >> 3;     // row group, 0..15
  const int q0 = blockIdx.x * BQ;
  const size_t qhead = static_cast<size_t>(blockIdx.y) * Lq * D;
  const size_t khead = static_cast<size_t>(blockIdx.y) * Lkv * D;

  for (int i = tid; i < BQ * DP; i += kThreads) {
    const int r = i / DP, c = i - r * DP;
    float x = 0.f;
    if (c < D && q0 + r < Lq) x = load_f(q + qhead + static_cast<size_t>(q0 + r) * D + c) * scale;
    qs[r * C::LDQ + c] = x;
  }

  float acc[RQ][DJ];
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += BK) {
    __syncthreads();  // every thread is done with the previous K/V/P tiles
    for (int i = tid; i < BK * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      float kx = 0.f, vx = 0.f;
      if (c < D && k0 + r < kv_len) {
        const size_t g = khead + static_cast<size_t>(k0 + r) * D + c;
        kx = load_f(k + g);
        vx = load_f(v + g);
      }
      ks[r * C::LDQ + c] = kx;
      vs[r * C::LDV + c] = vx;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DP; d += 4) {
      float4 a[RQ], b[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (rg * RQ + i) * C::LDQ + d);
#pragma unroll
      for (int j = 0; j < CK; ++j)
        b[j] = *reinterpret_cast<const float4*>(ks + (cg + 8 * j) * C::LDQ + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, b[j].x, t);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          t = fmaf(a[i].w, b[j].w, t);
          s[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        if (k0 + cg + 8 * j >= kv_len) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);   // finite: the tile holds a valid key
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(rg * RQ + i) * C::LDP + cg + 8 * j] = p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a row group's P rows are written and read by its own 8 lanes

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = ps[(rg * RQ + i) * C::LDP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vx = vs[kk * C::LDV + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(p[i], vx, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + rg * RQ + i;
    if (row >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = cg + 8 * j;
      if (c < D) store_f(o + qhead + static_cast<size_t>(row) * D + c, acc[i][j] / denom);
    }
  }
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int Lq,
           int Lkv, int kv_len, int D, float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  const size_t bytes = C::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DP, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + C::BQ - 1) / C::BQ, bh);
  flash_attention_kernel<DP, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Lq, Lkv, kv_len, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh, int Lq,
             int Lkv, int kv_len, int D, float scale, cudaStream_t s) {
  // DP: the smallest supported multiple of 8 that holds D.
  if (D <= 8) return launch<8, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  if (D <= 16) return launch<16, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  if (D <= 32) return launch<32, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  if (D <= 40) return launch<40, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  if (D <= 48) return launch<48, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  if (D <= 64) return launch<64, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  if (D <= 80) return launch<80, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  if (D <= 96) return launch<96, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  if (D <= 128) return launch<128, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  if (D <= 160) return launch<160, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  if (D <= 192) return launch<192, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  return launch<256, T>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
}

}  // namespace

// q, o: contiguous (bh, Lq, D); k, v: contiguous (bh, Lkv, D); all bf16
// (is_bf16 = 1) or all fp32. Keys at index >= kv_len are masked;
// 1 <= kv_len <= Lkv, 1 <= D <= 256. Returns a cudaError_t value (0 on success).
extern "C" int anyedit_flash_attention(const void* q, const void* k, const void* v,
                                       void* o, int bh, int Lq, int Lkv, int kv_len,
                                       int D, float scale, int is_bf16, void* stream) {
  if (bh < 1 || bh > 65535 || Lq < 1 || Lkv < 1 || kv_len < 1 || kv_len > Lkv ||
      D < 1 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
  return dispatch<float>(q, k, v, o, bh, Lq, Lkv, kv_len, D, scale, s);
}
