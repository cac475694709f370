// K1: max-free single-pass self-attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `anyedit_tpu/ops/attention.py::_flash_nomax_kernel`
// (wrapper `flash_nomax`). Same arithmetic and the same rounding points:
//   q' = bf16(fp32(q) * scale * log2(e))
//   s  = q' k^T                     (bf16 operands, fp32 accumulate)
//   p  = exp2(min(s, 80))           (fp32; the clamp replaces the running max)
//   l  = sum(p)                     (fp32, from the unrounded p)
//   o  = (bf16(p) v) / max(l, 1e-30)
//
// On the H100 this is bounded by tensor-core FLOPs: 4·L²·D per head, with
// D = 40 or 80 on the UNet's level-0 and level-1 self-attention. The simple
// design here: one block of 4 warps per (head, 64-row q tile); K/V stream
// through shared memory in 64-key tiles; each warp owns 16 q rows and runs
// bf16 WMMA (mma.sync) 16x16x16 tiles; the output accumulator stays in fp32
// fragments and l in fp32 registers. D is zero-padded in shared memory to a
// multiple of 16 (40 -> 48, 80 -> 80), which is exact. L is never padded: a
// zero key would add exp2(0) = 1 to l. Left for later: wgmma and TMA, a
// pipelined K/V ring, keeping S/P in registers instead of a shared-memory
// round trip, and vectorised global loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kClamp = 80.f;

template <int DP>
struct Layout {
  static constexpr int ldq = DP + 8;                                  // Q/K/V rows (bf16)
  static constexpr int lds = (DP > kBlockK ? DP : kBlockK) + 4;       // S and O staging (fp32)
  static constexpr int ldp = kBlockK + 8;                             // P rows (bf16)
  static constexpr size_t qkv_bytes = 3ull * kBlockQ * ldq * 2;
  static constexpr size_t s_bytes = 1ull * kWarps * 16 * lds * 4;
  static constexpr size_t p_bytes = 1ull * kWarps * 16 * ldp * 2;
  static constexpr size_t bytes = qkv_bytes + s_bytes + p_bytes;
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_nomax_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int L, int D, float qscale) {
  using Lay = Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kBlockQ * Lay::ldq;
  __nv_bfloat16* vs = ks + kBlockK * Lay::ldq;
  float* ss = reinterpret_cast<float*>(smem + Lay::qkv_bytes);
  __nv_bfloat16* ps =
      reinterpret_cast<__nv_bfloat16*>(smem + Lay::qkv_bytes + Lay::s_bytes);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = lane >> 1;   // each lane pair shares one of the warp's 16 rows
  const int half = lane & 1;   // and splits its columns even/odd
  float* sw = ss + warp * 16 * Lay::lds;
  __nv_bfloat16* pw = ps + warp * 16 * Lay::ldp;

  const size_t head = static_cast<size_t>(blockIdx.y) * L * D;
  const int q0 = blockIdx.x * kBlockQ;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  for (int i = threadIdx.x; i < kBlockQ * DP; i += kThreads) {
    const int r = i / DP, c = i - r * DP;
    float x = 0.f;
    if (c < D) x = __bfloat162float(q[head + static_cast<size_t>(q0 + r) * D + c]) * qscale;
    qs[r * Lay::ldq + c] = __float2bfloat16_rn(x);
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DP / 16];
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  float lsum = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = threadIdx.x; i < kBlockK * DP; i += kThreads) {
      const int r = i / DP, c = i - r * DP;
      const size_t g = head + static_cast<size_t>(k0 + r) * D + c;
      ks[r * Lay::ldq + c] = c < D ? k[g] : zero;
      vs[r * Lay::ldq + c] = c < D ? v[g] : zero;
    }
    __syncthreads();

    // S (16 x 64) = Q_warp (16 x DP) . K_tile^T (DP x 64)
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + warp * 16 * Lay::ldq + kk * 16, Lay::ldq);
        wmma::load_matrix_sync(b, ks + n * 16 * Lay::ldq + kk * 16, Lay::ldq);
        wmma::mma_sync(s, a, b, s);
      }
      wmma::store_matrix_sync(sw + n * 16, s, Lay::lds, wmma::mem_row_major);
    }
    __syncwarp();

    for (int c = half; c < kBlockK; c += 2) {
      const float p = exp2f(fminf(sw[row * Lay::lds + c], kClamp));
      lsum += p;
      pw[row * Lay::ldp + c] = __float2bfloat16_rn(p);
    }
    __syncwarp();

    // O (16 x DP) += P (16 x 64) . V_tile (64 x DP)
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, pw + kk * 16, Lay::ldp);
        wmma::load_matrix_sync(b, vs + kk * 16 * Lay::ldq + n * 16, Lay::ldq);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
  }

  lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
  const float denom = fmaxf(lsum, 1e-30f);
  __syncwarp();
#pragma unroll
  for (int n = 0; n < DP / 16; ++n)
    wmma::store_matrix_sync(sw + n * 16, acc[n], Lay::lds, wmma::mem_row_major);
  __syncwarp();
  const size_t orow = head + static_cast<size_t>(q0 + warp * 16 + row) * D;
  for (int c = half; c < D; c += 2)
    o[orow + c] = __float2bfloat16_rn(sw[row * Lay::lds + c] / denom);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int L,
           int D, float qscale, cudaStream_t stream) {
  const size_t bytes = Layout<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_nomax_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(L / kBlockQ, bh);
  flash_nomax_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), L, D,
      qscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous bf16 (bh, L, D). L % 64 == 0, 1 <= D <= 128.
// Returns a cudaError_t value (0 on success).
extern "C" int anyedit_flash_nomax_bf16(const void* q, const void* k, const void* v,
                                        void* o, int bh, int L, int D, float qscale,
                                        void* stream) {
  if (bh < 1 || bh > 65535 || L < kBlockQ || L % kBlockQ != 0 || D < 1 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return launch<16>(q, k, v, o, bh, L, D, qscale, s);
    case 2: return launch<32>(q, k, v, o, bh, L, D, qscale, s);
    case 3: return launch<48>(q, k, v, o, bh, L, D, qscale, s);
    case 4: return launch<64>(q, k, v, o, bh, L, D, qscale, s);
    case 5: return launch<80>(q, k, v, o, bh, L, D, qscale, s);
    case 6: return launch<96>(q, k, v, o, bh, L, D, qscale, s);
    case 7: return launch<112>(q, k, v, o, bh, L, D, qscale, s);
    default: return launch<128>(q, k, v, o, bh, L, D, qscale, s);
  }
}

extern "C" const char* anyedit_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
