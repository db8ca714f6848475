// K4: the vocab head of one greedy decode step. For the f32 LSTM state h
// (P, K), the projection W (K, N) in bf16 and its f32 bias b (N,), it
// computes per row the first argmax of s = bf16(h) @ W + b and the
// log-softmax there, and writes the step's bookkeeping: tok = END where
// the row is done, else argmax + 1; seq[:, t] = tok; lps[:, t] = 0 where
// done, else max - logsumexp(s); done |= tok == END.
//
// Replaces no TPU kernel: the JAX package leaves the projection, argmax
// and log-softmax of densecap_tpu/models/lstm.py:_greedy_decode to XLA,
// which keeps the scores on the chip. In PyTorch the same step writes the
// P x N f32 scores (320 MB at P = 8000, N = 10001), reads them for the
// argmax, reads and writes them for the log-softmax, gathers, and runs ~8
// small launches of bookkeeping: ~15 launches and 1.5-1.6 ms a step at
// P = 8000 on an H100. Here the scores never leave the SM; K4 takes
// 0.17 ms there, 47-48% of its bound (NVIDIA H100 80GB HBM3, 700 W).
//
// What bounds it: 2 P K N operations (81.9 GFLOP at P = 8000, K = 512,
// N = 10001) against ~27 MB of device memory (h in f32, W in bf16), so
// the tensor cores; with them the L2, since every row block walks all of
// W (~630 MB of L2 reads at P = 8000, 128-row blocks).
//
// Design (Hopper wgmma, warp-specialised):
//   * A CTA owns a row block of 64 G rows (G consumer warpgroups, 64 rows
//     each) and a slice of the vocab's 128-column tiles. It converts its
//     rows of h to bf16 once into shared memory, K-major and 128-byte
//     swizzled, where they stay for the whole walk (<= 128 KB: K <= 512 at
//     G = 2, K <= 1024 at G = 1).
//   * One producer lane streams W's tiles (K-major: W^T, padded by the
//     wrapper to 128 columns x 64 K) by TMA into a ring of 16 KB stages,
//     one (tile, 64-wide K chunk) a stage, completing on mbarriers. Both
//     warpgroups read each stage, so a stage is loaded once for 64 G rows.
//   * Each warpgroup runs wgmma.m64n128k16 with A and B from shared memory
//     and f32 sums in registers. After a tile it adds the bias, masks the
//     ragged vocab edge as -inf, and folds the tile into its rows' running
//     (max, first index of the max, sum of exp(s - max)): the online
//     log-sum-exp. Ties go to the lowest index within a thread (columns in
//     order, strict >), across a row's four lanes (lower index on equal
//     values) and across tiles (strict >).
//   * P = 8000 gives 63 row blocks of 128, fewer than the 132 SMs: the
//     wrapper splits the vocab into S slices (ops/greedy_head.py:plan) so
//     that row blocks x S fills the card in one wave. Each CTA writes its
//     rows' partials (max, index, sum), then takes a ticket of its row
//     block; the CTA that takes the last ticket combines the S partials in
//     slice order (strict >, so ties keep the lowest slice and index),
//     writes the bookkeeping and resets the ticket for the next launch.
//
// Numerics: the products are those of dot_f32 (bf16 operands, f32
// accumulation), the bias added in f32; only the order of the f32 sums
// differs from torch.mm's. The log-softmax is exact up to exp2f's and
// logf's rounding and the order of the sums.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kTileN = 128;                  // vocab columns per tile
constexpr int kChunk = 64;                   // K per stage: one 128 B row
constexpr int kRowBytes = kChunk * 2;
constexpr int kStageBytes = kTileN * kRowBytes;
constexpr int kStages = 5;
constexpr int kABytes = 128 * 1024;          // resident bf16 rows of h
constexpr int kMaxChunks = kABytes / (64 * kRowBytes);  // G x K chunks
constexpr int kBars = kABytes + kStages * kStageBytes;
constexpr int kSmemBytes = kBars + 2 * kStages * 8 + 16 + 1024;
constexpr float kLog2e = 1.4426950408889634f;

// TMA load of one box (64 K x 128 columns) of the 2-D (K, N) map of W^T.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int k, int n, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(n), "r"(bar)
      : "memory");
}

// d (64 x 128) = a (64 x 16) * b (16 x 128) + (accumulate ? d : 0), both
// operands K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// A barrier of the consumer warpgroups alone (the producer warp has left).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (m, i) becomes the larger of itself and (om, oi); equal values keep the
// lower index.
__device__ __forceinline__ void take_max(float& m, int& i, float om, int oi) {
  if (om > m || (om == m && oi < i)) {
    m = om;
    i = oi;
  }
}

template <int G>
__global__ void __launch_bounds__(G * 128 + 32, 1)
greedy_head_kernel(const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ h,
                   const float* __restrict__ bias, int P, int K, int N,
                   int S, int tiles, float* __restrict__ part,
                   unsigned int* __restrict__ tickets,
                   long long* __restrict__ tok, int* __restrict__ seq,
                   float* __restrict__ lps, int T, int t,
                   unsigned char* __restrict__ done, int end) {
  constexpr int kConsumers = G * 128;
  constexpr int kRows = 64 * G;
  constexpr int kChunkBytes = kRows * kRowBytes;  // one K chunk of A
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t a_s = base, ring_s = base + kABytes;
  const uint32_t full_bar = base + kBars;
  const uint32_t empty_bar = full_bar + 8 * kStages;
  int* last = reinterpret_cast<int*>(smem + kBars + 16 * kStages);

  const int tid = threadIdx.x;
  const int rb = blockIdx.x / S, slice = blockIdx.x % S;
  const int row0 = rb * kRows;
  const int tile0 = slice * tiles / S, tile1 = (slice + 1) * tiles / S;
  const int chunks = (K + kChunk - 1) / kChunk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);               // the producer's TMA
      mbar_init(empty_bar + 8 * s, 4 * G);          // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producer: one lane streams the slice's (tile, K chunk) stages.
    if (tid != kConsumers) return;
    int stage = 0;
    uint32_t parity = 1;  // the ring starts empty
    for (int tile = tile0; tile < tile1; ++tile) {
      for (int k = 0; k < chunks; ++k) {
        mbar_wait(empty_bar + 8 * stage, parity);
        mbar_expect_tx(full_bar + 8 * stage, kStageBytes);
        tma_load_2d(ring_s + stage * kStageBytes, &wmap, k * kChunk,
                    tile * kTileN, full_bar + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  // The row block's h in bf16, resident: chunk k holds 64-wide K slices of
  // kRows rows, 128 B a row, 16 B units swizzled by the row. Rows past P
  // and columns past K are zeros.
  {
    const bool vec = (K & 3) == 0;
    const int units = kRows * chunks * 8;
    for (int u = tid; u < units; u += kConsumers) {
      const int j = u & 7, k = (u >> 3) % chunks, r = (u >> 3) / chunks;
      const int row = row0 + r, col = k * kChunk + 8 * j;
      float v[8];
      if (row < P && vec && col + 8 <= K) {
        const float4* src =
            reinterpret_cast<const float4*>(h + static_cast<size_t>(row) * K + col);
        const float4 lo = __ldg(src), hi = __ldg(src + 1);
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (row < P && col + e < K)
                     ? h[static_cast<size_t>(row) * K + col + e]
                     : 0.0f;
      }
      const uint32_t dst = a_s + k * kChunkBytes + r * kRowBytes +
                           ((j ^ (r & 7)) << 4);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(dst),
                   "r"(bf16x2(v[0], v[1])), "r"(bf16x2(v[2], v[3])),
                   "r"(bf16x2(v[4], v[5])), "r"(bf16x2(v[6], v[7]))
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // for wgmma
  consumers_sync(kConsumers);

  // Warp wq of warpgroup g holds, per tile, rows 16 wq + lane / 4 (+ 8) of
  // g's 64 and columns 8 j + 2 (lane % 4) (+ 1), j = 0..15.
  const int warp = tid >> 5, lane = tid & 31;
  const int g = warp >> 2, wq = warp & 3;
  const int cq = lane & 3;
  const uint32_t a_g = a_s + g * 64 * kRowBytes;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float run_m[2] = {-INFINITY, -INFINITY}, run_s[2] = {0.0f, 0.0f};
  int run_i[2] = {0, 0};

  int stage = 0;
  uint32_t parity = 0;
  for (int tile = tile0; tile < tile1; ++tile) {
    fence_acc(acc);
    int prev = -1;
    for (int k = 0; k < chunks; ++k) {
      mbar_wait(full_bar + 8 * stage, parity);
      const uint32_t a = a_g + k * kChunkBytes;
      const uint32_t b = ring_s + stage * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_m64n128k16(acc, wgmma_desc(a + s * 32), wgmma_desc(b + s * 32),
                         (k | s) != 0);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();  // chunk k - 1 is done: its stage is free
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * prev);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * prev);

    // Epilogue: acc[4 j + 2 hh + u] is column n0 + 8 j + 2 cq + u of row
    // lane / 4 + 8 hh of the warp's 16.
    const int n0 = tile * kTileN;
    float2 bv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      bv[j] = __ldg(reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * cq));
    const bool edge = n0 + kTileN > N;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float m = -INFINITY;
      int mi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = n0 + 8 * j + 2 * cq + u;
          float v = acc[4 * j + 2 * hh + u] + (u ? bv[j].y : bv[j].x);
          if (edge && col >= N) v = -INFINITY;
          acc[4 * j + 2 * hh + u] = v;
          if (v > m) {
            m = v;
            mi = col;
          }
        }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        take_max(m, mi, __shfl_xor_sync(0xffffffffu, m, o),
                 __shfl_xor_sync(0xffffffffu, mi, o));
      const float nm = fmaxf(run_m[hh], m);
      if (m > run_m[hh]) run_i[hh] = mi;  // ties keep the earlier tile's
      const float nm2 = nm * kLog2e;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          sum += exp2f(fmaf(acc[4 * j + 2 * hh + u], kLog2e, -nm2));
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      // Every term of the tile is off by the same factor 2^e, e the
      // rounding of nm2 (|e| <= 2^-18 at |nm| < 88); rescaling by exactly 1
      // while the maximum holds keeps one such factor per term, where a
      // rescale computed as above would compound it over the tiles.
      if (nm != run_m[hh])
        run_s[hh] *= exp2f((run_m[hh] - nm) * kLog2e);
      run_s[hh] += sum;
      run_m[hh] = nm;
    }
  }

  // This slice's partials of its rows, then the row block's ticket.
  if (cq == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + g * 64 + 16 * wq + (lane >> 2) + 8 * hh;
      if (row < P) {
        float* p = part + (static_cast<size_t>(row) * S + slice) * 3;
        p[0] = run_m[hh];
        p[1] = __int_as_float(run_i[hh]);
        p[2] = run_s[hh];
      }
    }
  }
  __threadfence();
  consumers_sync(kConsumers);
  if (tid == 0) *last = atomicAdd(tickets + rb, 1u) == static_cast<unsigned>(S - 1);
  consumers_sync(kConsumers);
  if (!*last) return;

  // The last CTA of the row block combines the S slices in order.
  __threadfence();
  const int row = row0 + tid;
  if (tid < kRows && row < P) {
    const float* p = part + static_cast<size_t>(row) * S * 3;
    float m = __ldcg(p);
    int mi = __float_as_int(__ldcg(p + 1));
    for (int s = 1; s < S; ++s) {
      const float ms = __ldcg(p + 3 * s);
      if (ms > m) {  // ties keep the lower slice's index
        m = ms;
        mi = __float_as_int(__ldcg(p + 3 * s + 1));
      }
    }
    float sum = 0.0f;
    for (int s = 0; s < S; ++s)
      sum = fmaf(__ldcg(p + 3 * s + 2),
                 exp2f((__ldcg(p + 3 * s) - m) * kLog2e), sum);
    const bool was_done = done[row] != 0;
    const int tk = was_done ? end : mi + 1;
    tok[row] = tk;
    seq[static_cast<size_t>(row) * T + t] = tk;
    lps[static_cast<size_t>(row) * T + t] = was_done ? 0.0f : -logf(sum);
    done[row] = was_done || tk == end;
  }
  if (tid == 0) tickets[rb] = 0u;  // ready for the next launch
}

// W^T (n_pad, k_pad) bf16 row-major as a 2-D (K, N) map, read in boxes of
// 64 K x 128 columns, 128-byte swizzled.
bool w_map(CUtensorMap* map, const void* wt, int n_pad, int k_pad) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k_pad),
                              static_cast<cuuint64_t>(n_pad)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k_pad) * 2};
  const cuuint32_t box[2] = {kChunk, kTileN};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(wt), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int G>
int launch(const CUtensorMap& map, const float* h, const float* bias, int P,
           int K, int N, int S, int tiles, float* part, unsigned int* tickets,
           long long* tok, int* seq, float* lps, int T, int t,
           unsigned char* done, int end, cudaStream_t s) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return -1;
  // the attribute is per kernel and device: set once on each device, by
  // whichever thread launches there first (a repeat is harmless)
  static std::atomic<bool> ready[kMaxDevices];
  if (!ready[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(greedy_head_kernel<G>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev].store(true, std::memory_order_release);
  }
  const int blocks = (P + 64 * G - 1) / (64 * G) * S;
  greedy_head_kernel<G><<<blocks, G * 128 + 32, kSmemBytes, s>>>(
      map, h, bias, P, K, N, S, tiles, part, tickets, tok, seq, lps, T, t,
      done, end);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h: (P, K) f32 contiguous; wt: W^T zero-padded to (ceil(N / 128) 128,
// ceil(K / 64) 64) bf16 row-major; bias: (ceil(N / 128) 128,) f32.
// G (1 or 2) consumer warpgroups of 64 rows, G ceil(K / 64) <= 16; S
// vocab slices, 1 <= S <= ceil(N / 128). part: (P, S, 3) f32 scratch;
// tickets: ceil(P / (64 G)) uint32, zero before the first launch (each
// launch leaves them zero). Writes tok (P,) int64, seq[:, t] of (P, T)
// int32, lps[:, t] of (P, T) f32, and done (P,) bool in place.
// Launches on the current device. Returns a cudaError_t, -1 for an
// unsupported geometry or a device index of kMaxDevices or more, or -2 if
// W's TMA map cannot be encoded.
extern "C" int dc_greedy_head(const void* h, const void* wt, const void* bias,
                              int P, int K, int N, int G, int S, void* part,
                              void* tickets, void* tok, void* seq, void* lps,
                              int T, int t, void* done, int end,
                              void* stream) {
  const int chunks = (K + kChunk - 1) / kChunk;
  const int tiles = (N + kTileN - 1) / kTileN;
  if (P < 1 || K < 1 || N < 1 || (G != 1 && G != 2) ||
      G * chunks > kMaxChunks || S < 1 || S > tiles || t < 0 || t >= T)
    return -1;
  CUtensorMap map;
  if (!w_map(&map, wt, tiles * kTileN, chunks * kChunk)) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = G == 2 ? launch<2> : launch<1>;
  return run(map, static_cast<const float*>(h),
             static_cast<const float*>(bias), P, K, N, S, tiles,
             static_cast<float*>(part), static_cast<unsigned int*>(tickets),
             static_cast<long long*>(tok), static_cast<int*>(seq),
             static_cast<float*>(lps), T, t, static_cast<unsigned char*>(done),
             end, s);
}
