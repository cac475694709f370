// K4: online-softmax attention with int8 tensor-core products, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `anyedit_tpu/ops/attention.py::_flash_int8_kernel`
// (wrappers `flash_int8`, `_self_attn_int8`). The caller quantizes k per
// tensor and v per channel (`fac` = scale_k * softmax_scale, `sv` = the
// (bh, D) v scales); this kernel quantizes q per row and keeps the JAX
// kernel's order of operations:
//   sq  = max(absmax(q_row), 1e-8) / 127,  q8 = rint(q / sq)      (|q8| <= 127)
//   for each 64-key tile:
//     s32 = q8 k8^T (int32),  s = float(s32) * (sq * fac),  s = -inf at col >= kv_len
//     m_new = max(m, rowmax(s)),  p = exp(s - m_new) in (0, 1]
//     p8 = rint(p * 127),  pv = p8 v8 (int32)
//     c = exp(m - m_new),  l = l * c + rowsum(p)   (the unrounded p)
//     acc = acc * c + float(pv)
//   o = acc * (sv / 127) / max(l, 1e-30)
// Rounding is half to even (__float2int_rn), as jnp.round. p8 depends on
// the running max at its tile, so the result depends on the key tile: the
// plain version (`ops/attention.py::flash_int8_plain`) walks the same
// 64-key tiles.
//
// Both products are int8 WMMA (m16n16k16, int32 accumulate). D is
// zero-padded to a multiple of 16 in shared memory (40 -> 48, 80 -> 80),
// which is exact: a zero column changes no product and no absmax. L is not
// padded; keys past kv_len are zero in shared memory and masked to -inf.
// Bounded here by the shared-memory round trips: one block of 4 warps per
// (head, 64-row q tile), each warp owning 16 rows; S and each tile's PV go
// through shared memory because WMMA fragments have no portable element
// layout, and a lane pair owns one row (its m, l and D/2 fp32 accumulators
// in registers). Left for later: mma.sync / wgmma fragments in registers,
// cp.async or TMA K/V pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DP>
struct Layout {
  static constexpr int ld8 = DP + 16;                                  // int8 rows: q8, k8, v8
  static constexpr int ldp = kBlockK + 16;                             // p8 rows
  static constexpr int lds = (DP > kBlockK ? DP : kBlockK) + 4;        // int32 staging rows
  static constexpr size_t i8_bytes = 3ull * kBlockQ * ld8;
  static constexpr size_t p_bytes = 1ull * kWarps * 16 * ldp;
  static constexpr size_t s_bytes = 4ull * kWarps * 16 * lds;
  static constexpr size_t bytes = i8_bytes + p_bytes + s_bytes;
};

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
flash_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ k8,
                  const int8_t* __restrict__ v8, const float* __restrict__ fac,
                  const float* __restrict__ sv, T* __restrict__ o, int L, int kv_len,
                  int D) {
  using Lay = Layout<DP>;
  constexpr int NJ = DP / 2;   // accumulator columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  signed char* qs = reinterpret_cast<signed char*>(smem);
  signed char* ks = qs + kBlockQ * Lay::ld8;
  signed char* vs = ks + kBlockK * Lay::ld8;
  signed char* ps = vs + kBlockK * Lay::ld8;
  int* ss = reinterpret_cast<int*>(smem + Lay::i8_bytes + Lay::p_bytes);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = lane >> 1;   // each lane pair owns one of the warp's 16 rows
  const int half = lane & 1;   // and splits its columns even / odd
  signed char* pw = ps + warp * 16 * Lay::ldp;
  int* sw = ss + warp * 16 * Lay::lds;

  const size_t head = static_cast<size_t>(blockIdx.y) * L * D;
  const int r0 = blockIdx.x * kBlockQ + warp * 16 + row;   // this lane pair's q row
  const bool row_ok = r0 < L;
  const T* qrow = q + head + static_cast<size_t>(r0) * D;

  // q: per-row scale and int8 codes (each warp quantizes its own 16 rows)
  float amax = 0.f;
  if (row_ok)
    for (int c = half; c < D; c += 2) amax = fmaxf(amax, fabsf(load_f(qrow + c)));
  amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
  const float sq = fmaxf(amax, 1e-8f) / 127.f;
  signed char* qw = qs + (warp * 16 + row) * Lay::ld8;
  for (int c = half; c < DP; c += 2)
    qw[c] = static_cast<signed char>(
        (row_ok && c < D) ? __float2int_rn(load_f(qrow + c) / sq) : 0);
  const float row_f = sq * fac[0];

  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < kv_len; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = threadIdx.x; i < kBlockK * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      signed char kx = 0, vx = 0;
      if (c < D && k0 + r < kv_len) {
        const size_t g = head + static_cast<size_t>(k0 + r) * D + c;
        kx = k8[g];
        vx = v8[g];
      }
      ks[r * Lay::ld8 + c] = kx;
      vs[r * Lay::ld8 + c] = vx;
    }
    __syncthreads();

    // S (16 x 64) = Q8_warp (16 x DP) . K8_tile^T (DP x 64), int32
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> s;
      wmma::fill_fragment(s, 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + warp * 16 * Lay::ld8 + kk * 16, Lay::ld8);
        wmma::load_matrix_sync(b, ks + n * 16 * Lay::ld8 + kk * 16, Lay::ld8);
        wmma::mma_sync(s, a, b, s);
      }
      wmma::store_matrix_sync(sw + n * 16, s, Lay::lds, wmma::mem_row_major);
    }
    __syncwarp();

    float mx = -INFINITY;
    for (int c = half; c < kBlockK; c += 2) {
      const float x = k0 + c < kv_len ? static_cast<float>(sw[row * Lay::lds + c]) * row_f
                                      : -INFINITY;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);   // finite: the tile holds a valid key
    float rs = 0.f;
    for (int c = half; c < kBlockK; c += 2) {
      const float x = k0 + c < kv_len ? static_cast<float>(sw[row * Lay::lds + c]) * row_f
                                      : -INFINITY;
      const float p = expf(x - m_new);
      rs += p;
      pw[row * Lay::ldp + c] = static_cast<signed char>(__float2int_rn(p * 127.f));
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    const float corr = expf(m - m_new);
    l = l * corr + rs;
    m = m_new;
    __syncwarp();   // P8 is written, S is read: the staging rows are free for PV

    // PV (16 x DP) = P8 (16 x 64) . V8_tile (64 x DP), int32, fresh per tile
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> pv;
      wmma::fill_fragment(pv, 0);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b;
        wmma::load_matrix_sync(a, pw + kk * 16, Lay::ldp);
        wmma::load_matrix_sync(b, vs + kk * 16 * Lay::ld8 + n * 16, Lay::ld8);
        wmma::mma_sync(pv, a, b, pv);
      }
      wmma::store_matrix_sync(sw + n * 16, pv, Lay::lds, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      acc[j] = acc[j] * corr + static_cast<float>(sw[row * Lay::lds + 2 * j + half]);
    __syncwarp();   // staging rows are read before the next tile's S overwrites them
  }

  if (!row_ok) return;
  const float denom = fmaxf(l, 1e-30f);
  const float* svh = sv + static_cast<size_t>(blockIdx.y) * D;
  T* orow = o + head + static_cast<size_t>(r0) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = 2 * j + half;
    if (c < D) store_f(orow + c, acc[j] * (svh[c] / 127.f) / denom);
  }
}

template <int DP, typename T>
int launch(const void* q, const void* k8, const void* v8, const void* fac,
           const void* sv, void* o, int bh, int L, int kv_len, int D,
           cudaStream_t stream) {
  const size_t bytes = Layout<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_int8_kernel<DP, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, bh);
  flash_int8_kernel<DP, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<const float*>(fac),
      static_cast<const float*>(sv), static_cast<T*>(o), L, kv_len, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k8, const void* v8, const void* fac,
             const void* sv, void* o, int bh, int L, int kv_len, int D, cudaStream_t s) {
  switch ((D + 15) / 16) {
    case 1: return launch<16, T>(q, k8, v8, fac, sv, o, bh, L, kv_len, D, s);
    case 2: return launch<32, T>(q, k8, v8, fac, sv, o, bh, L, kv_len, D, s);
    case 3: return launch<48, T>(q, k8, v8, fac, sv, o, bh, L, kv_len, D, s);
    case 4: return launch<64, T>(q, k8, v8, fac, sv, o, bh, L, kv_len, D, s);
    case 5: return launch<80, T>(q, k8, v8, fac, sv, o, bh, L, kv_len, D, s);
    case 6: return launch<96, T>(q, k8, v8, fac, sv, o, bh, L, kv_len, D, s);
    case 7: return launch<112, T>(q, k8, v8, fac, sv, o, bh, L, kv_len, D, s);
    default: return launch<128, T>(q, k8, v8, fac, sv, o, bh, L, kv_len, D, s);
  }
}

}  // namespace

// q, o: contiguous (bh, L, D), bf16 (is_bf16 = 1) or fp32; k8, v8: contiguous
// int8 (bh, L, D); fac: one fp32 on the device; sv: contiguous fp32 (bh, D).
// 1 <= kv_len <= L, 1 <= D <= 128. Returns a cudaError_t value (0 on success).
extern "C" int anyedit_flash_int8(const void* q, const void* k8, const void* v8,
                                  const void* fac, const void* sv, void* o, int bh,
                                  int L, int kv_len, int D, int is_bf16, void* stream) {
  if (bh < 1 || bh > 65535 || L < 1 || kv_len < 1 || kv_len > L || D < 1 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch<__nv_bfloat16>(q, k8, v8, fac, sv, o, bh, L, kv_len, D, s);
  return dispatch<float>(q, k8, v8, fac, sv, o, bh, L, kv_len, D, s);
}
