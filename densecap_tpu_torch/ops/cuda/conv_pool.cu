// K3: fused 3x3 SAME conv + bias + ReLU + extent mask + 2x2/2 max pool +
// floor-halved mask, for trunk1's conv1_2+pool1 (C = 64) and
// conv2_2+pool2 (C = 128).
//
// Replaces densecap_tpu/ops/pallas/conv_pool_kernel.py:fused_conv_relu_pool
// (_kernel). The TPU kernel's w-paired layout, its 8-row blocks and its
// H % 8 / C*W limits are MXU and VMEM workarounds and are not carried
// over: this kernel takes any H, W >= 2 and C in {64, 128}.
//
// What it saves: the pre-pool activation (531 MB bf16 per stage at
// B = 8, 720 px) never reaches device memory; the conv's f32 sums are
// pooled in registers. What bounds it: the conv's 306 GFLOP per stage at
// B = 8 (2 * 9 * C^2 * B * H * W, the same at both stages) against
// 0.33-0.66 GB of device-memory traffic, i.e. 460-920 FLOP per byte,
// above the card's ~295 bf16 ridge: the tensor cores, and with them the
// SM's shared-memory bandwidth, since every k16 step of a warpgroup reads
// 2 KB of weights through the wgmma descriptor and 2 KB of activations
// through ldmatrix.
//
// bf16 design (Hopper wgmma, implicit GEMM, warp-specialised, persistent):
//   * GEMM view: a warpgroup's tile is M = 2 conv rows x 32 conv columns
//     = 64 pixels, N = 64 output channels, K = 9 taps x C input channels
//     in 64-channel chunks, one wgmma.m64n64k16 per k16 step with A from
//     registers and f32 accumulators. At C = 128 the output channels split
//     into two N blocks of 64 and each CTA owns one, so that its weights
//     stay resident (9 x 128 x 64 bf16 = 147 KB; all of C = 64's are
//     74 KB). They are loaded once per CTA, 128-byte swizzled K-major.
//   * One CTA per SM, persistent: two consumer warpgroups, each walking
//     its own tiles with its own two-stage halo ring, so one's epilogue
//     overlaps the other's wgmma; and one producer warp, one lane of
//     which loads each (tile, K chunk) halo of 4 rows x 34 columns x 64
//     channels with one TMA 4-D box, 128-byte swizzled, completing on an
//     mbarrier. Out-of-range coordinates, negative ones included, read as
//     zeros: the SAME padding.
//   * A: a tap (dy, dx) shifts the window, which no smem descriptor can
//     express, so A comes into registers with ldmatrix, one row address
//     per pixel. Each 8-row group of M holds pooled windows pc and pc + 2,
//     whose eight pixels fall on eight distinct swizzle phases of the
//     34-pixel halo rows: no bank conflicts.
//   * Pool in registers: the four pixels of a 2x2 window are consecutive
//     M rows (m = 4 pcl + 2 dc + dr in each 8-row group), so in the
//     accumulator layout the window sits in lanes l, l^4, l^8, l^12 and
//     the max is two shuffles.
//   * Epilogue, per sum, on bf16 pairs: round to bf16, add the bf16 bias
//     in f32 and round again (as a bf16 + bf16 add does), ReLU, the extent
//     mask (row < eh, col < ew); then the 2x2 max and the mask at
//     floor(eh/2), floor(ew/2). A trailing odd row or column is never
//     read, as max_pool2d floors. The pooled pairs go through 512 B of
//     shared memory per warp so that each lane stores 16 bytes.
// The first port's design (one WMMA 16x16x16 block per pooled-row strip)
// took 2.893 ms at C = 64 and 2.796 ms at C = 128 on an NVIDIA H100 80GB
// HBM3 at 700 W, 11% of the bf16 peak and slower than cuDNN plus a plain
// epilogue at C = 128. It was bound by (1) mma.sync fed by a
// shared-memory load of every B fragment by every warp, (2) the nine
// taps' C x C weights copied synchronously for every block, ~2.5 GB of
// L2 traffic per stage, (3) a synchronous halo load, 2x redundant, and
// (4) two blocks per SM at C = 128 with nothing overlapping loads and
// math. The design above answers each: wgmma, resident weights, TMA into
// a ring, persistent warp-specialised CTAs. A producer of per-lane 16-byte
// cp.async copies was tried first: its address arithmetic, not the
// tensor cores, bounded it at ~1.2 ms.
//
// f32 design (the f32 compute dtype; CUDA cores, fmaf): one block per
// (image, pooled row, strip of 16 pooled columns), one thread per output
// channel holding the 2 x 32 conv sums in registers; the halo is staged
// in shared memory and each input value, read once per channel, feeds all
// nine taps.
//
// Numerics: the numbers are those of F.conv2d in the compute dtype
// followed by the bias add, ReLU, mask, max_pool2d and mask
// (ops/conv_pool.py:conv_relu_pool_plain), up to the order of the f32
// sums.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kChunk = 64;                  // channels per K chunk, N block
constexpr int kMaxDevices = 64;             // per-device launch set-up
constexpr int kRowBytes = kChunk * 2;       // one 128 B swizzle row
constexpr int kTapBytes = kChunk * kRowBytes;  // 64 x 64 weights of a tap
constexpr int kTileCols = 32;               // conv columns per tile
constexpr int kTilePool = kTileCols / 2;    // pooled columns per tile
constexpr int kHaloRows = 4;
constexpr int kHaloCols = kTileCols + 2;    // also the staged row pitch
constexpr int kHaloBytes = kHaloRows * kHaloCols * kRowBytes;
constexpr int kGroups = 2;                  // consumer warpgroups
constexpr int kStages = 2;                  // halo ring depth per group
constexpr int kConsumers = kGroups * 128;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kPoolStage = 512;             // per-warp pooled bf16 staging

static_assert(kHaloCols % 8 == 2, "the M row order below relies on it");
static_assert(kHaloBytes % 1024 == 0, "halo buffers keep the swizzle atoms");

template <int C>
struct Bf16Smem {
  static constexpr int kK = C / kChunk;     // K chunks per tap = N blocks
  static constexpr int kHalo = 9 * kK * kTapBytes;
  static constexpr int kPool = kHalo + kGroups * kStages * kHaloBytes;
  static constexpr int kBars = kPool + 8 * kPoolStage;
  static constexpr int kBytes = kBars + 2 * kGroups * kStages * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// TMA load of one box of the 4-D (C, W, H, B) input; coordinates out of
// range (negative ones included) read as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c, int w, int h, int b,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(b),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Shared-memory descriptor of a 128-byte swizzled K-major operand whose
// 8-row atoms are 1024 B apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's fences and waits.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a (64 x 16, registers) * b (16 x 64, shared memory descriptor).
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return bf16x2_bits(r);
}

// Tiles are (image, pooled row, strip of 16 pooled columns), row-major.
struct Tile {
  int b, p, strip;
  __device__ Tile(int t, int strips, int Ho)
      : b(t / (strips * Ho)), p((t / strips) % Ho), strip(t % strips) {}
};

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
conv_pool_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __nv_bfloat16* __restrict__ wt,
                      const __nv_bfloat16* __restrict__ bias,
                      const float* __restrict__ ext, int B, int H, int W,
                      __nv_bfloat16* __restrict__ out) {
  using S = Bf16Smem<C>;
  constexpr int kK = S::kK;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // ring (group g, stage s): halo at halo_s + (g kStages + s) kHaloBytes,
  // barriers at full_bar / empty_bar + 8 (g kStages + s)
  const uint32_t w_s = base, halo_s = base + S::kHalo;
  const uint32_t full_bar = base + S::kBars;
  const uint32_t empty_bar = full_bar + 8 * kGroups * kStages;

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % kK) * kChunk;  // this CTA's output channels
  const int Ho = H / 2, Wo = W / 2;
  const int strips = (Wo + kTilePool - 1) / kTilePool;
  const int tiles = B * Ho * strips;
  // warpgroup g of CTA c takes tiles kGroups c + g + i kGroups ctas
  const int cta = blockIdx.x / kK, ctas = gridDim.x / kK;
  const int step = kGroups * ctas;

  // The N block's weights, all taps, resident: region (tap, K chunk) holds
  // 64 output-channel rows of 64 input channels, 16 B chunks swizzled.
  for (int v = tid; v < 9 * kK * kChunk * 8; v += kThreads) {
    const int j = v & 7, n = (v >> 3) & (kChunk - 1), tk = v >> 9;
    const int t = tk / kK, k = tk % kK;
    cp_async16(w_s + tk * kTapBytes + n * kRowBytes + ((j ^ (n & 7)) << 4),
               wt + (static_cast<size_t>(t * C + n0 + n) * C + k * kChunk +
                     j * 8));
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  if (tid == 0) {
    for (int s = 0; s < kGroups * kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);    // the producer's TMA
      mbar_init(empty_bar + 8 * s, 4);   // the group's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for wgmma
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: one lane loads the halo of every (tile, K chunk) into its
    // group's ring by TMA, the groups' tiles in turn. Both rings advance
    // kK stages per turn.
    if (tid != kConsumers) return;
    int stage = 0;
    uint32_t parity = 1;  // the rings start empty
    for (int t0 = kGroups * cta; t0 < tiles; t0 += step) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (t0 + g >= tiles) break;
        const Tile tl(t0 + g, strips, Ho);
        int s = stage;
        uint32_t ph = parity;
        for (int k = 0; k < kK; ++k) {
          const int ring = g * kStages + s;
          mbar_wait(empty_bar + 8 * ring, ph);
          mbar_expect_tx(full_bar + 8 * ring, kHaloBytes);
          tma_load_4d(halo_s + ring * kHaloBytes, &xmap, k * kChunk,
                      tl.strip * kTileCols - 1, 2 * tl.p - 1, tl.b,
                      full_bar + 8 * ring);
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
      for (int k = 0; k < kK; ++k) {
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  // Consumers. Warp wq of warpgroup g owns pooled columns 4 wq + pp,
  // pp = 0..3, of g's tile; its 16 M rows are m = 8 hh + 4 pcl + 2 dc + dr
  // with pp = 2 pcl + hh: pixel (conv row dr, conv column 2 pc + dc). An
  // 8-row group thus holds windows pc and pc + 2, whose eight pixels fall
  // on eight distinct swizzle phases of the 34-pixel halo rows.
  const int warp = tid >> 5, lane = tid & 31;
  const int g = warp >> 2, wq = warp & 3;
  // the ldmatrix row this lane addresses, and its 8-channel K half
  const int lm = (lane & 7) + ((lane >> 3) & 1) * 8, kc = lane >> 4;
  const int lpp = 2 * ((lm >> 2) & 1) + (lm >> 3);
  const int a_pix =
      (lm & 1) * kHaloCols + 2 * (4 * wq + lpp) + ((lm >> 1) & 1);
  // the accumulator rows this lane holds: lane / 4 and lane / 4 + 8
  const int dr = (lane >> 2) & 1, dc = (lane >> 3) & 1, pcl = lane >> 4;
  const int quad = (lane >> 2) & 3, cpair = lane & 3;
  float bv[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
      bv[2 * j + u] = __bfloat162float(bias[n0 + 8 * j + 2 * cpair + u]);
  unsigned char* pool_buf = smem + S::kPool + warp * kPoolStage;

  int stage = 0;
  uint32_t parity = 0;
  for (int tile = kGroups * cta + g; tile < tiles; tile += step) {
    const Tile tl(tile, strips, Ho);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    fence_acc(acc);
    for (int k = 0; k < kK; ++k) {
      const int ring = g * kStages + stage;
      mbar_wait(full_bar + 8 * ring, parity);
      const uint32_t halo = halo_s + ring * kHaloBytes;
      const uint32_t wk = w_s + k * kTapBytes;
      uint32_t a[2][4][4];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int pix = a_pix + (t / 3) * kHaloCols + t % 3;
        const uint32_t row = halo + pix * kRowBytes;
#pragma unroll
        for (int s = 0; s < 4; ++s)
          ldmatrix_x4(row + (((2 * s + kc) ^ (pix & 7)) << 4), a[t & 1][s]);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_m64n64k16(acc, a[t & 1][s],
                          wgmma_desc(wk + t * kK * kTapBytes + s * 32));
        wgmma_commit();
        wgmma_wait<1>();  // tap t - 1 is done: its A registers are free
      }
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * ring);
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }

    // Epilogue on bf16 pairs: acc[4 j + 2 hh + u] is output channel
    // n0 + 8 j + 2 cpair + u of M row lane / 4 + 8 hh.
    const float eh = ext[2 * tl.b], ew = ext[2 * tl.b + 1];
    const bool prow = static_cast<float>(tl.p) < floorf(eh * 0.5f);
    const bool row_in = static_cast<float>(2 * tl.p + dr) < eh;
    const float fw = floorf(ew * 0.5f);
    const int pc0 = tl.strip * kTilePool + 4 * wq;
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int pp = 2 * pcl + hh, pc = pc0 + pp;
      const bool in = row_in && static_cast<float>(2 * pc + dc) < ew;
      const bool keep = prow && static_cast<float>(pc) < fw;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 sum = __bfloat1622float2(__floats2bfloat162_rn(
            acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]));
        const __nv_bfloat162 y = __hmax2(
            __floats2bfloat162_rn(sum.x + bv[2 * j], sum.y + bv[2 * j + 1]),
            zero);
        uint32_t v = in ? bf16x2_bits(y) : 0u;
        v = bf16x2_max(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = bf16x2_max(v, __shfl_xor_sync(0xffffffffu, v, 8));
        // the window's four lanes share the result; each stores two chunks
        if ((j >> 1) == quad)
          *reinterpret_cast<uint32_t*>(pool_buf + pp * kRowBytes + j * 16 +
                                       cpair * 4) = keep ? v : 0u;
      }
    }
    __syncwarp();
    {
      const int pp = lane >> 3, j = lane & 7, pc = pc0 + pp;
      if (pc < Wo)
        *reinterpret_cast<uint4*>(
            out + ((static_cast<size_t>(tl.b) * Ho + tl.p) * Wo + pc) * C +
            n0 + 8 * j) =
            *reinterpret_cast<const uint4*>(pool_buf + pp * kRowBytes +
                                            j * 16);
    }
    __syncwarp();
  }
}

constexpr int kF32PoolCols = 16;
constexpr int kF32ConvCols = 2 * kF32PoolCols;
constexpr int kF32HaloCols = kF32ConvCols + 2;

template <int C>
__global__ void __launch_bounds__(C)
conv_pool_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                     const float* __restrict__ bias,
                     const float* __restrict__ ext, int H, int W,
                     float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [4][kF32HaloCols][C]
  const int strip = blockIdx.x;
  const int p = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = strip * kF32ConvCols;
  const int co = threadIdx.x;
  const int Ho = H / 2, Wo = W / 2;

  for (int v = co; v < 4 * kF32HaloCols * C; v += C) {
    const int pix = v / C, ch = v % C;
    const int rr = pix / kF32HaloCols, cc = pix % kF32HaloCols;
    const int row = 2 * p - 1 + rr, col = c0 - 1 + cc;
    float val = 0.0f;
    if (row >= 0 && row < H && col >= 0 && col < W)
      val = x[(((size_t)b * H + row) * W + col) * C + ch];
    xs[v] = val;
  }
  __syncthreads();

  float acc[2][kF32ConvCols];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < kF32ConvCols; ++j) acc[r][j] = 0.0f;

  for (int ci = 0; ci < C; ++ci) {
    float w[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) w[t] = wt[((size_t)t * C + ci) * C + co];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float v[kF32HaloCols];
#pragma unroll
      for (int cc = 0; cc < kF32HaloCols; ++cc)
        v[cc] = xs[(rr * kF32HaloCols + cc) * C + ci];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int dy = rr - r;
        if (dy < 0 || dy > 2) continue;
#pragma unroll
        for (int j = 0; j < kF32ConvCols; ++j)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            acc[r][j] = fmaf(v[j + dx], w[dy * 3 + dx], acc[r][j]);
      }
    }
  }

  const float eh = ext[2 * b], ew = ext[2 * b + 1];
  const bool prow_ok = (float)p < floorf(eh * 0.5f);
  const float fw = floorf(ew * 0.5f);
  const float bv = bias[co];
#pragma unroll
  for (int j = 0; j < kF32PoolCols; ++j) {
    const int pc = strip * kF32PoolCols + j;
    if (pc >= Wo) break;
    float m = 0.0f;
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
#pragma unroll
      for (int dc = 0; dc < 2; ++dc) {
        const int row = 2 * p + dr, col = 2 * pc + dc;
        float y = fmaxf(acc[dr][2 * j + dc] + bv, 0.0f);
        if (!((float)row < eh && (float)col < ew)) y = 0.0f;
        m = fmaxf(m, y);
      }
    }
    if (!(prow_ok && (float)pc < fw)) m = 0.0f;
    out[(((size_t)b * Ho + p) * Wo + pc) * C + co] = m;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: its address comes from the
// runtime's entry-point query, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The NHWC input as a 4-D (C, W, H, B) map, read in boxes of 64 channels x
// a tile's halo (34 columns x 4 rows), 128-byte swizzled.
bool halo_map(CUtensorMap* map, const void* x, int B, int H, int W, int C) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(W) * C * 2,
                                 static_cast<cuuint64_t>(H) * W * C * 2};
  const cuuint32_t box[4] = {kChunk, kHaloCols, kHaloRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C>
int launch_bf16(const void* x, const void* wt, const void* bias,
                const void* ext, int B, int H, int W, void* out,
                cudaStream_t s) {
  using S = Bf16Smem<C>;
  CUtensorMap xmap;
  if (!halo_map(&xmap, x, B, H, W, C)) return -2;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return -1;
  // the attribute is per kernel and device: set once on each device, by
  // whichever thread launches there first (a repeat is harmless)
  static std::atomic<int> sms_of[kMaxDevices];
  int sms = sms_of[dev].load(std::memory_order_acquire);
  if (sms == 0) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(conv_pool_bf16_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               S::kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    sms_of[dev].store(sms, std::memory_order_release);
  }
  // one CTA per SM, two tiles at a time; at C = 128 the CTAs pair up,
  // one per N block
  const int tiles = B * (H / 2) * ((W / 2 + kTilePool - 1) / kTilePool);
  const int pairs = (tiles + kGroups - 1) / kGroups;
  const int per_block = sms / S::kK > 0 ? sms / S::kK : 1;
  const int grid = S::kK * (pairs < per_block ? pairs : per_block);
  conv_pool_bf16_kernel<C><<<grid, kThreads, S::kBytes, s>>>(
      xmap, static_cast<const __nv_bfloat16*>(wt),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const float*>(ext),
      B, H, W, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_f32(const void* x, const void* wt, const void* bias,
               const void* ext, int B, int H, int W, void* out,
               cudaStream_t s) {
  constexpr int kSmem = 4 * kF32HaloCols * C * 4;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return -1;
  static std::atomic<bool> ready[kMaxDevices];  // per device, as above
  if (!ready[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(
        conv_pool_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev].store(true, std::memory_order_release);
  }
  const int Wo = W / 2;
  dim3 grid((Wo + kF32PoolCols - 1) / kF32PoolCols, H / 2, B);
  conv_pool_f32_kernel<C><<<grid, C, kSmem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt),
      static_cast<const float*>(bias), static_cast<const float*>(ext), H, W,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, C) NHWC contiguous, bf16 (dtype 1) or f32 (dtype 0).
// wt: (3, 3, C, C) in the same dtype, [dy][dx][co][ci] for bf16 (K-major
// for the wgmma) and [dy][dx][ci][co] for f32; bias: (C,) same dtype;
// ext: (B, 2) f32 per-image (eh, ew). out: (B, H/2, W/2, C).
// C must be 64 or 128, H and W >= 2. Launches on the current device.
// Returns a cudaError_t, -1 for an unsupported geometry or a device index
// of kMaxDevices or more, or -2 if the input's TMA map cannot be encoded.
extern "C" int dc_conv_relu_pool(const void* x, const void* wt,
                                 const void* bias, const void* ext, int B,
                                 int H, int W, int C, int dtype, void* out,
                                 void* stream) {
  if (H < 2 || W < 2 || B < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (C == 64) return launch_bf16<64>(x, wt, bias, ext, B, H, W, out, s);
    if (C == 128) return launch_bf16<128>(x, wt, bias, ext, B, H, W, out, s);
  } else if (dtype == 0) {
    if (C == 64) return launch_f32<64>(x, wt, bias, ext, B, H, W, out, s);
    if (C == 128) return launch_f32<128>(x, wt, bias, ext, B, H, W, out, s);
  }
  return -1;
}
