// K5: LayerNorm over the last dimension for Hopper (sm_90a).
//
// The port's `models/layers.py::LayerNorm` (the JAX package's is plain XLA,
// `anyedit_tpu/models/layers.py::LayerNorm`; no TPU kernel). Input is
// contiguous (rows, C) in bf16 or fp32; each row is normalised on its own.
// The arithmetic is the plain version's (`ops/layernorm.py::
// layer_norm_plain`): fp32 statistics, the mean first and then the two-pass
// variance sum((x - mean)^2) / C (never E[x^2] - E[x]^2), then
// y = (x - mean) * rsqrt(var + eps) * weight + bias with each product and sum
// rounded on its own (no fused multiply-add, as the plain version's separate
// elementwise kernels round them), fp32 weight and bias, and one rounding to
// the output dtype (bf16 or fp32) at the end.
//
// What bounds it on the H100: HBM bytes, one read of x and one write of y
// (the SD1.5 UNet's level-0 norm at batch 12, 49,152 rows of 320 in bf16, is
// 63 MB: 18.8 us at 3.35 TB/s). The design moves each byte once:
//   * a row is held by a group of `warps` warps (one for the widths of every
//     model in the port, up to 2,048 bf16 or 1,024 fp32 elements), each
//     thread keeping up to VPL vectors of the row in registers between the
//     mean, the variance and the write; a block holds several one-warp rows;
//   * 16-byte vector loads of x, and stores of y of the same element count,
//     where C is a multiple of the vector and the pointers are 16-byte
//     aligned; scalar accesses (VEC = 1) otherwise;
//   * the sums are reduced with warp shuffles; a row of several warps adds
//     the warps' partial sums through 8 floats of shared memory, every
//     thread in the same order.
// The vector width, VPL, the warps a row and the rows a block are chosen by
// `_k5_plan` in `ops/layernorm.py` and passed in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxVpl = 8;
constexpr int kMaxThreads = 256;   // 8 warps: up to 255 registers a thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N elements of T moved as one access (two for 32 bytes).
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

// The sum of `s` over the row's threads, the same value in each. A row of
// several warps fills red[warp] and reads it back in warp order.
__device__ __forceinline__ float row_sum(float s, int warps, float* red, int sub, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (warps == 1) return s;
  if (lane == 0) red[sub] = s;
  __syncthreads();
  float tot = 0.f;
  for (int i = 0; i < warps; ++i) tot += red[i];
  __syncthreads();  // red is written again by the next sum
  return tot;
}

template <typename Tin, typename Tout, int VEC, int VPL>
__global__ void __launch_bounds__(kMaxThreads) k5_layer_norm_rows(
    const Tin* __restrict__ x, const float* __restrict__ weight,
    const float* __restrict__ bias, Tout* __restrict__ y, long long rows, int C,
    int warps, float eps) {
  __shared__ float red[kMaxThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = warp % warps;                      // the warp's place in its row
  const int rows_per_block = blockDim.x / (32 * warps);
  const long long row = blockIdx.x * static_cast<long long>(rows_per_block) + warp / warps;
  // Only one-warp rows can be past the end (several-warp rows take one
  // block each), and they sync nothing but their own warp.
  if (row >= rows) return;
  const int t = sub * 32 + lane;
  const int tpr = warps * 32;
  const int nvec = C / VEC;
  using InPack = Pack<Tin, VEC>;
  using OutPack = Pack<Tout, VEC>;
  using WPack = Pack<float, VEC>;
  const InPack* xr = reinterpret_cast<const InPack*>(x + row * C);

  float v[VPL][VEC];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int k = t + i * tpr;
    if (k < nvec) {
      const InPack p = xr[k];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[i][j] = to_float(p.v[j]);
        s += v[i][j];
      }
    }
  }
  const float mean = row_sum(s, warps, red, sub, lane) / static_cast<float>(C);

  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (t + i * tpr < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[i][j] = __fsub_rn(v[i][j], mean);
        q += v[i][j] * v[i][j];
      }
    }
  }
  const float var = row_sum(q, warps, red, sub, lane) / static_cast<float>(C);
  const float r = rsqrtf(__fadd_rn(var, eps));

  OutPack* yr = reinterpret_cast<OutPack*>(y + row * C);
  const WPack* wp = reinterpret_cast<const WPack*>(weight);
  const WPack* bp = reinterpret_cast<const WPack*>(bias);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int k = t + i * tpr;
    if (k < nvec) {
      const WPack w = wp[k];
      const WPack b = bp[k];
      OutPack o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_float<Tout>(__fadd_rn(__fmul_rn(__fmul_rn(v[i][j], r), w.v[j]), b.v[j]));
      yr[k] = o;
    }
  }
}

template <typename Tin, typename Tout, int VEC>
int launch(const void* x, const void* w, const void* b, void* y, long long rows, int C,
           float eps, int vpl, int warps, int rows_per_block, cudaStream_t stream) {
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(static_cast<unsigned>(32 * warps * rows_per_block));
  const Tin* xp = static_cast<const Tin*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  Tout* yp = static_cast<Tout*>(y);
#define K5_LAUNCH(N)                                                                   \
  case N:                                                                              \
    k5_layer_norm_rows<Tin, Tout, VEC, N>                                              \
        <<<grid, block, 0, stream>>>(xp, wp, bp, yp, rows, C, warps, eps);             \
    break;
  switch (vpl) {
    K5_LAUNCH(1)
    K5_LAUNCH(2)
    K5_LAUNCH(3)
    K5_LAUNCH(4)
    K5_LAUNCH(5)
    K5_LAUNCH(6)
    K5_LAUNCH(7)
    K5_LAUNCH(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int dispatch(const void* x, const void* w, const void* b, void* y, long long rows, int C,
             float eps, int vec, int vpl, int warps, int rows_per_block, cudaStream_t s) {
  if (vec == 1)
    return launch<Tin, Tout, 1>(x, w, b, y, rows, C, eps, vpl, warps, rows_per_block, s);
  return launch<Tin, Tout, static_cast<int>(16 / sizeof(Tin))>(x, w, b, y, rows, C, eps, vpl,
                                                             warps, rows_per_block, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x: contiguous (rows, C) in bf16 (in_bf16 = 1) or fp32; weight, bias: fp32
// (C,); y: contiguous (rows, C) in bf16 (out_bf16 = 1) or fp32. `vec` is
// 16 / sizeof(x's element) (16-byte accesses: C a multiple of it and every
// pointer 16-byte aligned) or 1 (scalar); each row runs on `warps` warps
// (1, 2, 4 or 8) whose threads keep `vpl` (1..8) accesses of it each,
// enough to cover the row; a block holds `rows_per_block` rows, 1 where a
// row takes several warps. Returns a cudaError_t value (0 on success).
extern "C" int anyedit_layer_norm(const void* x, const void* weight, const void* bias,
                                  void* y, long long rows, int C, float eps, int in_bf16,
                                  int out_bf16, int vec, int vpl, int warps,
                                  int rows_per_block, void* stream) {
  const int in_vec = in_bf16 ? 8 : 4;
  const bool pow2 = warps >= 1 && warps <= kMaxThreads / 32 && (warps & (warps - 1)) == 0;
  if (rows < 1 || C < 1 || !pow2 || vpl < 1 || vpl > kMaxVpl || rows_per_block < 1 ||
      (warps > 1 && rows_per_block != 1) || 32LL * warps * rows_per_block > kMaxThreads ||
      (vec != 1 && vec != in_vec) || C % vec != 0 ||
      static_cast<long long>(C / vec) > 32LL * warps * vpl ||
      (rows + rows_per_block - 1) / rows_per_block > 0x7fffffffLL ||
      (vec != 1 && !(aligned16(x) && aligned16(weight) && aligned16(bias) && aligned16(y))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(x, weight, bias, y, rows, C, eps, vec, vpl,
                                                  warps, rows_per_block, s);
  if (in_bf16)
    return dispatch<__nv_bfloat16, float>(x, weight, bias, y, rows, C, eps, vec, vpl, warps,
                                          rows_per_block, s);
  if (out_bf16)
    return dispatch<float, __nv_bfloat16>(x, weight, bias, y, rows, C, eps, vec, vpl, warps,
                                          rows_per_block, s);
  return dispatch<float, float>(x, weight, bias, y, rows, C, eps, vec, vpl, warps,
                                rows_per_block, s);
}
