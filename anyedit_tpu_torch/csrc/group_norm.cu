// K2: GroupNorm with optional fused SiLU for Hopper (sm_90a).
//
// Replaces the TPU kernel `anyedit_tpu/ops/groupnorm.py::_gn_kernel`
// (wrapper `_gn_pallas`). Input is contiguous NCHW, so each (image, group)
// is one contiguous span of C/G * H * W elements. Statistics are fp32 and
// two-pass: the mean first, then sum((x - mean)^2) (never E[x^2] - E[x]^2,
// which cancels when |mean| >> std). Then y = x * a + b with
// a = rsqrt(var + eps) * scale[c], b = bias[c] - mean * a, and y * sigmoid(y)
// when SiLU is on. Input and output are bf16 or fp32.
//
// What bounds it on the H100: HBM bytes, one read and one write of the
// activation (the VAE's (1, 128, 512, 512) bf16 is 134 MB, 0.040 ms at
// 3.35 TB/s). The design:
//   * one launch; each span is split over a thread block cluster of 1-16
//     blocks (`cudaLaunchKernelEx` with a cluster dimension), so the VAE's
//     32 spans of 1-2 M elements run on 512 blocks, not 32. A span small
//     enough for one block (the UNet's 8x8 and 16x16 levels) takes a plain
//     launch and skips the cluster barriers;
//   * each block copies its chunk of the span into shared memory with
//     16-byte `cp.async` copies and keeps it there, so x is read from HBM
//     once. Where a chunk exceeds the shared memory it is given (96 KB, so
//     that two blocks share an SM: the VAE's 512^2 spans and its 512-channel
//     256^2 ones), the part past it is read again from global memory (mostly
//     the L2) for the second and third pass;
//   * the blocks of a cluster exchange their partial sums through
//     distributed shared memory (`map_shared_rank` after `cluster.sync()`),
//     first for the mean and then for sum((x - mean)^2) over the resident
//     chunk; every block adds the partials in the same order, so all agree
//     on the statistics to the bit;
//   * the write pass reads the chunk from shared memory 16 bytes at a time,
//     applies the affine and SiLU in registers and stores 16 bytes at a time.
//     A head or tail that is not 16-byte aligned (H*W not a multiple of 8)
//     takes scalar accesses; a y whose alignment differs from x's takes
//     scalar stores.
// The cluster size and the chunk are chosen by `_k2_plan` in
// `ops/groupnorm.py` and passed in. Left for later: fusing the statistics
// into the producing add or convolution.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T as V floats, and back.
template <typename T> struct Vec {
  static constexpr int V = 16 / sizeof(T);
  __device__ static void load(const T* p, float (&f)[V]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_float(e[i]);
  }
  __device__ static void store(T* p, const float (&f)[V]) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_float<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

// Elements before the first 16-byte boundary at p, at most n.
template <typename T>
__device__ __forceinline__ int head_elems(const T* p, long long n) {
  const int h = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
                static_cast<int>(sizeof(T));
  return static_cast<int>(h < n ? h : n);
}

// Calls f(i, x_i) for every i in [0, n) of p, each once, spread over the
// block: the aligned middle with 16-byte loads, head and tail scalar.
template <typename T, typename F>
__device__ __forceinline__ void visit(const T* p, long long n, F f) {
  constexpr int V = Vec<T>::V;
  if (n <= 0) return;
  const int head = head_elems(p, n);
  const long long nvec = (n - head) / V;
  const long long tail0 = head + nvec * V;
  for (long long k = threadIdx.x; k < nvec; k += kThreads) {
    float x[V];
    Vec<T>::load(p + head + k * V, x);
#pragma unroll
    for (int j = 0; j < V; ++j) f(head + k * V + j, x[j]);
  }
  if (threadIdx.x < head) f(threadIdx.x, to_float(p[threadIdx.x]));
  if (threadIdx.x < n - tail0) f(tail0 + threadIdx.x, to_float(p[tail0 + threadIdx.x]));
}

// y, or SiLU(y) = y * sigmoid(y) = y / (1 + e^-y); for y < -88, e^-y is
// inf and the fast divide returns 0.
__device__ __forceinline__ float act(float y, int silu) {
  return silu ? __fdividef(y, 1.f + __expf(-y)) : y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block; every thread gets the total.
__device__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
  __shared__ float total;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) total = t;
  }
  __syncthreads();
  return total;
}

// Sum of every block's slot over the cluster, added in rank order (the same
// order in every block); every thread gets it.
__device__ float cluster_sum(cg::cluster_group& cluster, float* slot, float mine) {
  __shared__ float total;
  if (threadIdx.x == 0) *slot = mine;
  cluster.sync();
  if (threadIdx.x == 0) {
    const int n = static_cast<int>(cluster.num_blocks());
    float t = 0.f;
    for (int r = 0; r < n; ++r) t += *cluster.map_shared_rank(slot, r);
    total = t;
  }
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int C, int HW, int G,
                  long long chunk, long long cap, float eps, int silu) {
  constexpr int V = Vec<T>::V;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float slots[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int span_id = blockIdx.x / static_cast<int>(cluster.num_blocks());
  const int n = span_id / G, g = span_id % G;
  const int cg_ = C / G;
  const long long span = static_cast<long long>(cg_) * HW;
  const long long base = (static_cast<long long>(n) * C + static_cast<long long>(g) * cg_) * HW;

  // This block's chunk [lo, lo + cnt) of the span; the first `res` elements
  // stay in shared memory, at an offset that gives them x's 16-byte phase.
  const long long lo = rank * chunk;
  long long cnt = span - lo;
  cnt = cnt < chunk ? cnt : chunk;
  cnt = cnt > 0 ? cnt : 0;
  const long long res = cnt < cap ? cnt : cap;
  const T* xs = x + base + lo;
  T* ys = y + base + lo;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(xs) & 15) / sizeof(T));
  T* sm = reinterpret_cast<T*>(smem_raw) + mis;

  // Pass 1: chunk -> shared memory (cp.async), and its sum.
  if (res > 0) {
    const int head = head_elems(xs, res);
    const long long nvec = (res - head) / V;
    const long long tail0 = head + nvec * V;
    for (long long k = threadIdx.x; k < nvec; k += kThreads) {
      const uint32_t dst =
          static_cast<uint32_t>(__cvta_generic_to_shared(sm + head + k * V));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(xs + head + k * V));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if (threadIdx.x < head) sm[threadIdx.x] = xs[threadIdx.x];
    if (threadIdx.x < res - tail0) sm[tail0 + threadIdx.x] = xs[tail0 + threadIdx.x];
    asm volatile("cp.async.wait_all;\n" ::);
  }
  __syncthreads();
  float s = 0.f;
  visit(sm, res, [&](long long, float v) { s += v; });
  visit(xs + res, cnt - res, [&](long long, float v) { s += v; });
  const float count = static_cast<float>(span);
  const bool alone = cluster.num_blocks() == 1;  // no cluster barriers needed
  const float sum = block_sum(s);
  const float mean = (alone ? sum : cluster_sum(cluster, &slots[0], sum)) / count;

  // Pass 2: sum((x - mean)^2).
  float s2 = 0.f;
  const auto sq = [&](long long, float v) {
    const float d = v - mean;
    s2 += d * d;
  };
  visit(sm, res, sq);
  visit(xs + res, cnt - res, sq);
  const float sum2 = block_sum(s2);
  const float inv = rsqrtf((alone ? sum2 : cluster_sum(cluster, &slots[1], sum2)) / count + eps);

  // Pass 3: y = x * a + b (+ SiLU), 16-byte stores where y's phase matches x's.
  const auto affine = [&](long long i, float v) {
    const int c = g * cg_ + static_cast<int>((lo + i) / HW);
    const float a = inv * scale[c];
    return act(v * a + (bias[c] - mean * a), silu);
  };
  const bool same_phase =
      ((reinterpret_cast<uintptr_t>(ys) ^ reinterpret_cast<uintptr_t>(xs)) & 15) == 0;
  if (same_phase && cnt > 0) {
    const int head = head_elems(xs, cnt);
    const long long nvec = (cnt - head) / V;
    const long long tail0 = head + nvec * V;
    for (long long k = threadIdx.x; k < nvec; k += kThreads) {
      const long long i0 = head + k * V;
      float v[V];
      if (i0 + V <= res) {
        Vec<T>::load(sm + i0, v);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = to_float(i0 + j < res ? sm[i0 + j] : xs[i0 + j]);
      }
      // One channel lookup per vector unless it straddles a channel edge.
      int c = g * cg_ + static_cast<int>((lo + i0) / HW);
      long long edge = (static_cast<long long>(c - g * cg_) + 1) * HW - lo;
      float a = inv * scale[c];
      float b = bias[c] - mean * a;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (i0 + j == edge) {
          ++c;
          edge += HW;
          a = inv * scale[c];
          b = bias[c] - mean * a;
        }
        v[j] = act(v[j] * a + b, silu);
      }
      Vec<T>::store(ys + i0, v);
    }
    const auto one = [&](long long i) {
      ys[i] = from_float<T>(affine(i, to_float(i < res ? sm[i] : xs[i])));
    };
    if (threadIdx.x < head) one(threadIdx.x);
    if (threadIdx.x < cnt - tail0) one(tail0 + threadIdx.x);
  } else {
    for (long long i = threadIdx.x; i < cnt; i += kThreads)
      ys[i] = from_float<T>(affine(i, to_float(i < res ? sm[i] : xs[i])));
  }
  if (!alone) cluster.sync();  // no block leaves while another may still read its slots
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y, int N, int C,
           int HW, int G, float eps, int silu, int cluster, long long chunk,
           long long cap, int smem, cudaStream_t stream) {
  auto* kernel = group_norm_kernel<T>;
  // The attributes only grow; set them when a launch needs more (one host
  // thread launches).
  static int smem_set = 0;
  static bool wide_set = false;
  cudaError_t err = cudaSuccess;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  if (cluster > 8 && !wide_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    wide_set = true;
  }
  if (cluster == 1) {  // a plain launch: a block is then a cluster of one
    kernel<<<N * G, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<T*>(y), C, HW, G, chunk, cap, eps, silu);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(N) * G * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           static_cast<const float*>(scale), static_cast<const float*>(bias),
                           static_cast<T*>(y), C, HW, G, chunk, cap, eps, silu);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: contiguous (N, C, H*W) in bf16 (is_bf16 = 1) or fp32; scale, bias:
// fp32 (C,). Each (image, group) span runs on a cluster of `cluster` blocks
// (1..16), block r taking elements [r * chunk, (r + 1) * chunk); the first
// `cap` elements of a chunk stay in `smem` bytes of shared memory, which
// must hold cap + 16 bytes of alignment slack. Returns a cudaError_t value
// (0 on success).
extern "C" int anyedit_group_norm(const void* x, const void* scale, const void* bias,
                                  void* y, int N, int C, int HW, int G, float eps,
                                  int silu, int is_bf16, int cluster, long long chunk,
                                  long long cap, int smem, void* stream) {
  const long long span = C % G == 0 ? static_cast<long long>(C / G) * HW : 0;
  const int eb = is_bf16 ? 2 : 4;
  if (N < 1 || G < 1 || C % G != 0 || HW < 1 || cluster < 1 || cluster > kMaxCluster ||
      chunk < 1 || cluster * chunk < span || cap < 0 ||
      smem < (cap < chunk ? cap : chunk) * eb + 16 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, scale, bias, y, N, C, HW, G, eps, silu, cluster, chunk,
                                 cap, smem, s);
  return launch<float>(x, scale, bias, y, N, C, HW, G, eps, silu, cluster, chunk, cap, smem,
                       s);
}
