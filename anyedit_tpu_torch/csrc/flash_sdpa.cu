// K6: Flux's joint attention on Hopper's warpgroup tensor cores (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs Flux's attention as
// `anyedit_tpu/ops/attention.py::sdpa_xla`, and so did the port (`sdpa`:
// five PyTorch kernels, fp32 logits of (B, H, L, L) written and read in
// device memory, and QK^T on the CUDA cores in fp32). Same function, with no
// bias and D = 128 (wrapper `ops/attention.py::flash_sdpa`, plain version
// `flash_sdpa_plain`):
//   s = q k^T (bf16 products, fp32 sums),  t = s * scale * log2(e)
//   for each 128-key tile:  m_new = max(m, rowmax(t)),  p = ex2(t - m_new),
//     c = ex2(m - m_new),  l = l * c + rowsum(p),  acc = acc * c + bf16(p) v
//   o = bf16(acc / l)
// p is rounded to bf16 for the P.V product (sdpa rounds the normalised
// probabilities to v's dtype; here the division comes after the product);
// l sums the fp32 p. Tile 0 holds key 0, so m is finite after it and
// ex2(m - m_new) never meets -inf - (-inf). Keys past L in the last tile are
// zero-filled by the copy and masked to -inf before the max.
//
// Bound. At Flux's (24 heads, 1,280 tokens, D 128) a block's attention is
// 20.1 GFLOP of bf16 products (20.4 us at 989 TFLOP/s), 39.3 M ex2 (about
// 9.4 us at 16 a clock an SM) and 31.5 MB of q, k, v and o (9.4 us): the
// tensor cores bind, so the products have to run on `wgmma`, and the logits
// and probabilities never leave the registers.
//
// Design. A block owns one (batch, head) and 128 q rows; grid (q tiles, H,
// B). Warpgroup 0 is the producer, one thread of which issues TMA copies:
//   * Q once, into shared memory (the A operand of QK^T);
//   * K and V in 128-key tiles through a ring of 2 slots, each tile with
//     its own full and empty `mbarrier`, so QK^T starts when K has arrived,
//     while V is still on its way.
// Warpgroups 1 and 2 are consumers of 64 q rows each; `setmaxnreg` moves
// registers from the producer (24 a thread) to them (240: S, O and P live
// at once). Every tile lies in shared memory as 64-column halves of
// 128-byte rows in TMA's 128-byte swizzle, which is the layout `wgmma`
// reads without bank conflicts:
//   * S = Q K^T is 8 `wgmma.m64n128k16` from shared memory (K-major A, B);
//   * the online softmax runs on the 64 fp32 accumulators a thread holds
//     (its two rows' maxima reduced over a lane quad with two shuffles, each
//     exponential one FFMA and one `ex2.approx`, row sums kept per thread
//     and reduced once at the end);
//   * P is packed to bf16 in registers: the m64n128 accumulator of two
//     8-key column groups is exactly a `wgmma` A fragment of 16 keys;
//   * O += P V is 8 `wgmma.m64n128k16` with A from registers and V read
//     through a transposed (MN-major) descriptor.
// A consumer issues tile j's QK^T together with tile j - 1's P.V, so the
// softmax of S_j runs while P.V is on the tensor cores, and the two
// consumers take turns to issue (named barriers), so that one's softmax
// runs while the other's products do. q, k and v are read through their
// (B, H, L) strides, with unit stride in D: a view such as Flux's
// single-block v, (B, L, H, D) permuted, is read where it lies. The output
// is written through its strides too: the wrapper hands the (B, L, H, D)
// buffer that Flux's merge of the heads reads as it is. On the H100 at
// (1, 24, 1280, 128) this takes 43.5-44.5 us, 46-47 % of the bound;
// without the turns 44.4 us, with 3 ring slots no faster, with one
// consumer warpgroup (64 q rows a block) 58.4 us.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the shared-memory attribute is set at the first launch
// (an eager call, before any graph capture), and the tensor maps are
// encoded on the host at each launch and passed by value.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime

#include "sm90_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;        // head dim
constexpr int kBlockN = 128;   // keys a tile
constexpr int kBox = 64;       // a TMA box: 64 rows x 64 columns, 128-byte rows
constexpr int kBoxBytes = kBox * kBox * 2;
constexpr int kTileBytes = kBlockN * kD * 2;   // one K or V tile
constexpr int kHalfBytes = kBlockN * kBox * 2; // its 64-column half
constexpr int kMaxSmem = 232448;
// Registers a thread after the warpgroups re-balance them (`setmaxnreg`):
// the launch gives each of the 384 threads 168; the producer keeps 24, and
// the consumers, which hold S, O and P (160 a thread) while a P.V product
// is in flight, take 240 (168 serialises the `wgmma`s and spills).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

constexpr int kConsumers = 2;                 // consumer warpgroups, 64 q rows each
constexpr int kBlockM = 64 * kConsumers;      // q rows a block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;                    // K and V tiles in flight
constexpr int kQBytes = kBlockM * kD * 2;
constexpr int kBarOff = kQBytes + 2 * kStages * kTileBytes;
constexpr int kSmemBytes = kBarOff + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
static_assert(kSmemBytes <= kMaxSmem, "K6's shared memory exceeds a block's limit");

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 64 x 64 box of a (B, H, L, D) tensor: columns d0 .. d0 + 63 of rows
// row0 .. row0 + 63 of head h of batch b. `hl` says the map's dims are
// (D, H, L, B) rather than (D, L, H, B) (a tensor whose head stride is the
// smaller, so the map's strides rise).
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, uint64_t* bar, int d0,
                                        int row0, int h, int b, bool hl) {
  const int c1 = hl ? h : row0, c2 = hl ? row0 : h;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(d0), "r"(c1), "r"(c2),
      "r"(b)
      : "memory");
}

// A `wgmma` shared-memory descriptor in the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from touching registers that an issued `wgmma` writes
// or reads before the wait that retires it.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[kBlockN / 16][4]) {
#pragma unroll
  for (int i = 0; i < kBlockN / 16; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

#define K6_D64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define K6_D64_OPS                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),         \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),         \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),         \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),         \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),         \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),         \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),         \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),         \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128 fp32) (+)= A (64 x 16 bf16, shared, K-major) . B (16 x 128
// bf16, shared, K-major); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " K6_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : K6_D64_OPS
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128 fp32) += A (64 x 16 bf16, registers) . B (16 x 128 bf16,
// shared, MN-major: the descriptor transposes it).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " K6_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : K6_D64_OPS
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 128 keys) = Q K^T: 8 k16 steps over D, each 16 columns (32
// bytes) into a 128-byte row of one 64-column half.
__device__ __forceinline__ void qk(float (&sc)[64], uint32_t q_base, uint32_t k_base) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(sc, gmma_desc(q_base + (kk / 4) * kBlockM * 128 + off, 16, 1024),
             gmma_desc(k_base + (kk / 4) * kHalfBytes + off, 16, 1024), kk > 0);
  }
}

// acc (64 x 128) += P V: 8 k16 steps over the tile's keys (16 rows of 128
// bytes each); the two 64-column halves of V are the descriptor's leading
// offset apart.
__device__ __forceinline__ void pv(float (&acc)[64], const uint32_t (&pa)[kBlockN / 16][4],
                                   uint32_t v_base) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
    wgmma_rs(acc, pa[kk], gmma_desc(v_base + kk * 16 * 128, kHalfBytes, 1024));
}

// Keys at or past `valid` of this tile to -inf; a thread holds columns
// 8 i + 2 t and 8 i + 2 t + 1 of its two rows.
__device__ __forceinline__ void mask_tail(float (&sc)[64], int valid, int t) {
  if (valid >= kBlockN) return;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int col = 8 * i + 2 * t;
    if (col >= valid) sc[4 * i] = sc[4 * i + 2] = -INFINITY;
    if (col + 1 >= valid) sc[4 * i + 1] = sc[4 * i + 3] = -INFINITY;
  }
}

// The online softmax of a thread's two rows (g and g + 8 of its warp's 16;
// accumulator entries 4 i, 4 i + 1 and 4 i + 2, 4 i + 3): running max in
// base-2 units, per-thread partial row sums, the last tile's rescale factor.
struct Softmax {
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float corr[2] = {0.f, 0.f};

  // S -> p = ex2(s * qk_scale - m_new) in place; l rescaled and summed.
  __device__ __forceinline__ void step(float (&sc)[64], float qk_scale) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
      const float mn = fmaxf(m[r], mx[r] * qk_scale);
      corr[r] = fast_exp2(m[r] - mn);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        sc[4 * i + e] = fast_exp2(fmaf(sc[4 * i + e], qk_scale, -m[r]));
        l[r] += sc[4 * i + e];
      }
    }
  }
  __device__ __forceinline__ void rescale(float (&acc)[64]) const {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      acc[4 * i] *= corr[0];
      acc[4 * i + 1] *= corr[0];
      acc[4 * i + 2] *= corr[1];
      acc[4 * i + 3] *= corr[1];
    }
  }
  // The row's whole sum, over the lane quad.
  __device__ __forceinline__ float total(int r) const {
    float x = l[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    return x;
  }
};

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, each 256 threads: one warpgroup waits, the other
// arrives), so that one's softmax runs while the other's products hold the
// tensor cores. Warpgroup 1 lets warpgroup 0 go first and skips its last
// pass, so each barrier sees as many arrivals as waits.
struct Turns {
  int wg;
  __device__ __forceinline__ explicit Turns(int wg_) : wg(wg_) {
    if (wg == 1) arrive(0);
  }
  __device__ __forceinline__ void take() const {
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
  }
  __device__ __forceinline__ void pass() const { arrive(1 - wg); }
  __device__ __forceinline__ void last() const {
    if (wg == 0) arrive(1);
  }
  __device__ __forceinline__ static void arrive(int to) {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + to) : "memory");
  }
};

// p (fp32 in the S accumulators) -> bf16 A fragments of P.V: keys 16 kk ..
// 16 kk + 15 are the accumulators of 8-key groups 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[kBlockN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_sdpa_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                      long long o_sb, long long o_sh, long long o_sl, int L, float qk_scale,
                      int hl_mask) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* qs = smem;              // [half][128 q rows][64 columns]
  uint8_t* ks = qs + kQBytes;      // kStages x [half][128 keys][64 columns]
  uint8_t* vs = ks + kStages * kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nk = (L + kBlockN - 1) / kBlockN;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 128 * kConsumers);
      mbar_init(v_empty + s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {  // producer warpgroup: one thread issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      const bool q_hl = hl_mask & 1, k_hl = hl_mask & 2, v_hl = hl_mask & 4;
      mbar_expect_tx(q_full, kQBytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int half = 0; half < 2; ++half)
          tma_box(qs + half * kBlockM * 128 + c * kBoxBytes, &tq, q_full, half * kBox,
                  qt * kBlockM + c * kBox, h, b, q_hl);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kStages, u = j / kStages;
        if (u > 0) mbar_wait(k_empty + s, (u - 1) & 1);
        mbar_expect_tx(k_full + s, kTileBytes);
        for (int c = 0; c < 2; ++c)
          for (int half = 0; half < 2; ++half)
            tma_box(ks + s * kTileBytes + half * kHalfBytes + c * kBoxBytes, &tk, k_full + s,
                    half * kBox, j * kBlockN + c * kBox, h, b, k_hl);
        if (u > 0) mbar_wait(v_empty + s, (u - 1) & 1);
        mbar_expect_tx(v_full + s, kTileBytes);
        for (int c = 0; c < 2; ++c)
          for (int half = 0; half < 2; ++half)
            tma_box(vs + s * kTileBytes + half * kHalfBytes + c * kBoxBytes, &tv, v_full + s,
                    half * kBox, j * kBlockN + c * kBox, h, b, v_hl);
      }
    }
    return;
  }

  // consumer warpgroup wg: q rows 64 wg .. 64 wg + 63 of the tile. Only
  // the rescale of O and the packing of P_j wait for P_{j-1} V_{j-1}.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4 - 1;
  const uint32_t q_base = smem_addr(qs) + wg * kBoxBytes;
  float acc[64], sc[64];
  uint32_t pa[kBlockN / 16][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  Softmax sm;
  const Turns turns{wg};
  mbar_wait(q_full, 0);

  mbar_wait(k_full, 0);
  turns.take();
  wgmma_fence();
  qk(sc, q_base, smem_addr(ks));
  wgmma_commit();
  turns.pass();
  wgmma_wait<0>();
  fence_regs(sc);
  mbar_arrive(k_empty);
  if (nk == 1) mask_tail(sc, L, lane % 4);
  sm.step(sc, qk_scale);
  pack_p(sc, pa);

  for (int j = 1; j < nk; ++j) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(k_full + s, (j / kStages) & 1);
    mbar_wait(v_full + sp, ((j - 1) / kStages) & 1);
    turns.take();
    wgmma_fence();
    qk(sc, q_base, smem_addr(ks + s * kTileBytes));
    wgmma_commit();
    pv(acc, pa, smem_addr(vs + sp * kTileBytes));
    wgmma_commit();
    turns.pass();
    wgmma_wait<1>();  // S_j
    fence_regs(sc);
    mbar_arrive(k_empty + s);
    if (j == nk - 1) mask_tail(sc, L - j * kBlockN, lane % 4);
    sm.step(sc, qk_scale);
    wgmma_wait<0>();  // P_{j-1} V_{j-1}
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(v_empty + sp);
    sm.rescale(acc);
    pack_p(sc, pa);
  }
  const int sl = (nk - 1) % kStages;
  mbar_wait(v_full + sl, ((nk - 1) / kStages) & 1);
  turns.take();
  wgmma_fence();
  pv(acc, pa, smem_addr(vs + sl * kTileBytes));
  wgmma_commit();
  turns.last();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);

  const float r0 = 1.f / sm.total(0), r1 = 1.f / sm.total(1);
  const int g = lane / 4, t = lane % 4;
  const int row0 = qt * kBlockM + wg * 64 + (warp % 4) * 16 + g;
  bf16* ob = o + b * o_sb + h * o_sh;
  if (row0 < L) {
    bf16* orow = ob + row0 * o_sl + 2 * t;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      store_f2(orow + 8 * i, acc[4 * i] * r0, acc[4 * i + 1] * r0);
  }
  if (row0 + 8 < L) {
    bf16* orow = ob + (row0 + 8) * o_sl + 2 * t;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      store_f2(orow + 8 * i, acc[4 * i + 2] * r1, acc[4 * i + 3] * r1);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's `cuTensorMapEncodeTiled`, found through the runtime (no link to
// libcuda); nullptr where libcuda lacks it.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a bf16 (B, H, L, 128) tensor with element strides (sb, sh, sl)
// and unit stride in D, in 64 x 64 boxes with the 128-byte swizzle; rows
// past L read as zeros. Its dims are (D, L, H, B), or (D, H, L, B) where sh
// < sl (`*hl` set), so that the strides rise.
bool encode(CUtensorMap* map, const void* ptr, int B, int H, int L, long long sb, long long sh,
            long long sl, bool* hl) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  *hl = sh < sl;
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(*hl ? H : L),
                              static_cast<cuuint64_t>(*hl ? L : H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>((*hl ? sh : sl) * 2),
                                 static_cast<cuuint64_t>((*hl ? sl : sh) * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {kBox, *hl ? 1u : static_cast<cuuint32_t>(kBox),
                             *hl ? static_cast<cuuint32_t>(kBox) : 1u, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k, v: bf16 (B, H, L, 128) with element strides sq, sk, sv (batch,
// head, row; unit stride in D), each a multiple of 8 and each base 16-byte
// aligned; o: bf16 (B, H, L, 128) with even strides so and a 4-byte
// aligned base, written. Returns a cudaError_t value (0 on success).
extern "C" int anyedit_flash_sdpa(const void* q, const void* k, const void* v, void* o,
                                  const long long* sq, const long long* sk, const long long* sv,
                                  const long long* so, int B, int H, int L, float scale,
                                  void* stream) {
  const auto ok16 = [](const void* p, const long long* s) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % 8 == 0 && s[1] % 8 == 0 &&
           s[2] % 8 == 0 && s[0] > 0 && s[1] > 0 && s[2] > 0;
  };
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1 || !ok16(q, sq) || !ok16(k, sk) ||
      !ok16(v, sv) || reinterpret_cast<uintptr_t>(o) % 4 != 0 || so[0] % 2 != 0 ||
      so[1] % 2 != 0 || so[2] % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  bool hq, hk, hv;
  if (!encode(&tq, q, B, H, L, sq[0], sq[1], sq[2], &hq) ||
      !encode(&tk, k, B, H, L, sk[0], sk[1], sk[2], &hk) ||
      !encode(&tv, v, B, H, L, sv[0], sv[1], sv[2], &hv))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // one host thread launches; set at the first launch
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_sdpa_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int hl_mask = (hq ? 1 : 0) | (hk ? 2 : 0) | (hv ? 4 : 0);
  const float qk_scale = scale * 1.4426950408889634f;  // logits in base 2
  const dim3 grid((L + kBlockM - 1) / kBlockM, H, B);
  flash_sdpa_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<bf16*>(o), so[0], so[1], so[2], L, qk_scale, hl_mask);
  return static_cast<int>(cudaGetLastError());
}
