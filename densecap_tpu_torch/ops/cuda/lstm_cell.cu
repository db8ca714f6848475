// K5: one LSTM step of the greedy decode. For P rows, the step's input x
// (E wide: the embedding row of each row's last token, or the encoded
// image), the state h and c (H wide) and the cell's weights Wx (E, 4H),
// Wh (H, 4H) and f32 bias b (4H,) with torch-rnn's gate order (i, f, o,
// g), it computes
//
//   gates = bf16([x | h]) @ bf16([Wx ; Wh]) + b
//   c2 = sigmoid(f) c + sigmoid(i) tanh(g);   h2 = sigmoid(o) tanh(c2)
//
// and writes h2 and c2 in f32 and h2 in bf16 (the next step's operand);
// the P x 4H gates never leave the SM.
//
// Replaces no TPU kernel: the JAX package leaves _lstm_step and _embed of
// densecap_tpu/models/lstm.py to XLA, which fuses the gates' pointwise
// work into the products' epilogue on the chip. In PyTorch the same step
// is the embedding's clamp and gather, two bf16 products with f32 outputs
// (each casting its operands first) and ~10 pointwise passes over the
// P x 4H f32 gates: ~20 launches and ~0.65 ms a step at P = 8000, H = 512
// on an H100. K5 takes 0.079 ms there, 42-43% of its bound (NVIDIA H100
// 80GB HBM3, 700 W).
//
// What bounds it: 2 P (E + H) 4H operations (33.6 GFLOP at P = 8000,
// E = H = 512: 0.034 ms at 989 TFLOP/s) against ~86 MB of device memory
// (x, h and c read and h and c written in f32, W in bf16: 0.026 ms at
// 3.35 TB/s), so the tensor cores; with them the L2, since every column
// tile re-reads its rows of [x | h] and every row block all of W.
//
// Design (Hopper wgmma, warp-specialised, persistent, one launch a step):
//   * A tile is 128 rows (two consumer warpgroups of 64) by 64 hidden
//     units, i.e. 256 gate columns. The wrapper (ops/lstm_cell.py:pack)
//     permutes the 4H columns of [Wx ; Wh] so that column 32 q + 8 gate +
//     e of a tile is gate `gate` of unit 8 q + e: wgmma's accumulator
//     fragment then gives each thread i, f, o and g of the same two units
//     of its two rows, and the cell's epilogue runs in registers. W is
//     stored transposed (K-major), K = Ep + Hp with x's and h's columns
//     each zero-padded to a multiple of 64.
//   * One CTA an SM walks the tiles blockIdx.x, + gridDim.x, ...; tiles of
//     one row block are adjacent, so its rows of [x | h] come from device
//     memory about once and from the L2 for the other column tiles, and W
//     (4 MB at H = 512) stays in the L2.
//   * A producer warpgroup fills a ring of 48 KB stages, one 64-wide K
//     chunk a stage, running on into the next tile while the consumers
//     finish this one: W's 256 x 64 tile by TMA, completing on the stage's
//     mbarrier, and the 128 rows of [x | h] by 16-byte cp.async copies,
//     128-byte swizzled by hand, rows past P zero-filled. x's rows are
//     gathered: for a token step, row clamp(tok - 1, 0, rows - 1) of the
//     bf16 embedding table the wrapper made; for the image step, the
//     encoded image cast to bf16. h is read in bf16, from the buffer the
//     previous step wrote (two buffers in turns: other tiles still read
//     the old h while this one writes the new). Each producer warp signals
//     a stage once its copies have landed and are fenced for the async
//     proxy. The producers give their registers to the consumers
//     (setmaxnreg), whose sums, c and epilogue need 232 a thread.
//   * Each consumer warpgroup runs wgmma.m64n256k16 with both operands in
//     shared memory and f32 sums in registers, releasing a stage once the
//     next chunk's products are issued. It reads the tile's c before its
//     products, so the read hides behind them; then the epilogue adds the
//     bias and writes c2, h2 and bf16(h2). c is updated in place: each
//     (row, unit) belongs to one thread.
//   * The epilogue, ~40% of the time, stalls the tensor cores: the cell's
//     transcendentals and the writes of h and c. The sigmoid's reciprocal
//     takes the division's fast path without its branch (rcp_ge1), which
//     let the compiler interleave the cells (0.103 -> 0.086 ms a step at
//     P = 8000 on the H100 above; persistent CTAs then 0.079).
//
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kRows = 128;                    // rows a tile: 2 warpgroups
constexpr int kTileN = 256;                   // gate columns a tile
constexpr int kUnits = kTileN / 4;            // hidden units a tile
constexpr int kChunk = 64;                    // K per stage: one 128 B row
constexpr int kRowBytes = kChunk * 2;
constexpr int kABytes = kRows * kRowBytes;    // 16 KB of [x | h] a stage
constexpr int kBBytes = kTileN * kRowBytes;   // 32 KB of W a stage
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kStages = 4;
constexpr int kLag = 1;  // stages whose copies a producer keeps in flight
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kProducers = 128;               // one warpgroup
// Registers a thread: the producers give theirs up to the consumers, whose
// 128 f32 sums, c and the epilogue's temporaries need more than the 168 a
// thread of three warpgroups gets. 2 x 128 x 232 + 128 x 40 <= 65 536.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBars = kStages * kStageBytes;
constexpr int kSmemBytes = kBars + 2 * kStages * 8 + 1024;
// A consumer frees chunk k's stage once it has issued chunk k + 1, so a
// producer waiting for a free stage must have signalled the chunk after it.
static_assert(kLag + 2 <= kStages, "the producer would wait on itself");
static_assert(2 * 128 * kConsumerRegs + kProducers * kProducerRegs <= 65536,
              "more registers than an SM has");

// TMA load of one box (64 K x 256 columns) of the 2-D (K, N) map of W^T.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int k, int n, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(n), "r"(bar)
      : "memory");
}

// 16 bytes from global to shared memory; the bytes past `bytes` (all 16
// when it is 0) are zeros. Through the L1 (.ca): in a decode most rows
// often share a token, so one tile's 128 rows gather the same embedding
// row, which the L1 then serves; through the L2 alone (.cg) those reads
// all queue on one line, and the step took twice as long.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// d (64 x 256) = a (64 x 16) * b (16 x 256) + (accumulate ? d : 0), both
// operands K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 1 / y for y >= 1 without the division's branch to its slow path: the
// hardware's approximation and one Newton step, which is bit-equal to the
// correctly rounded quotient for every y in [1, 2^126) (checked on the card
// over all of them). Above 2^126, where 1 / y is subnormal, it gives 0.
__device__ __forceinline__ float rcp_ge1(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  const float e = fmaf(-y, r, 1.0f);
  return y == INFINITY ? 0.0f : fmaf(r, e, r);
}

// PyTorch's f32 sigmoid on the card, 1 / (1 + exp(-x)), bit for bit while
// sigmoid(x) is a normal number (x > -87.3; below, 0).
__device__ __forceinline__ float sigmoid(float x) {
  return rcp_ge1(1.0f + expf(-x));
}

__global__ void __launch_bounds__(kConsumers + kProducers, 1)
lstm_cell_kernel(const __grid_constant__ CUtensorMap wmap,
                 const __nv_bfloat16* __restrict__ xsrc, int xrows,
                 const long long* __restrict__ tok,
                 const __nv_bfloat16* __restrict__ hb_in,
                 const float* __restrict__ bias, float* __restrict__ c,
                 float* __restrict__ h_out, __nv_bfloat16* __restrict__ hb_out,
                 int P, int H, int Ep, int Hp, int tiles, int total) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full_bar = base + kBars;
  const uint32_t empty_bar = full_bar + 8 * kStages;

  const int tid = threadIdx.x;
  const int xchunks = Ep / kChunk, chunks = xchunks + Hp / kChunk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1 + 4);  // W's TMA, every producer warp
      mbar_init(empty_bar + 8 * s, 8);      // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // Producers: thread p copies 16-byte unit j = p % 8 of rows p / 8 + 16 i,
    // i = 0..7, of every chunk; thread 0 also loads W's tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int p = tid - kConsumers, j = p & 7;
    int stage = 0, signal = 0, issued = 0;
    uint32_t parity = 1;  // the ring starts empty
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int ct = tile % tiles, row0 = tile / tiles * kRows;
    int xoff[8];  // element offsets of the rows' x in xsrc, -1 past P
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + (p >> 3) + 16 * i;
      int idx = row;
      if (tok != nullptr && row < P) {
        const long long t = tok[row] - 1;
        idx = static_cast<int>(t < 0 ? 0 : (t >= xrows ? xrows - 1 : t));
      }
      xoff[i] = row < P ? idx * Ep + 8 * j : -1;
    }
    for (int k = 0; k < chunks; ++k) {
      mbar_wait(empty_bar + 8 * stage, parity);
      const uint32_t a_s = base + stage * kStageBytes;
      if (p == 0) {
        mbar_expect_tx(full_bar + 8 * stage, kBBytes);
        tma_load_2d(a_s + kABytes, &wmap, k * kChunk, ct * kTileN,
                    full_bar + 8 * stage);
      }
      const bool xk = k < xchunks;
      const __nv_bfloat16* src =
          xk ? xsrc + k * kChunk : hb_in + (k - xchunks) * kChunk;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (p >> 3) + 16 * i;
        const bool ok = xoff[i] >= 0;
        const int off = xk ? xoff[i] : (row0 + r) * Hp + 8 * j;
        cp_async_16(a_s + r * kRowBytes + ((j ^ (r & 7)) << 4),
                    ok ? src + off : src, ok ? 16 : 0);
      }
      cp_async_commit();
      if (issued++ >= kLag) {  // the chunk kLag before has landed
        cp_async_wait<kLag>();
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        if ((p & 31) == 0) mbar_arrive(full_bar + 8 * signal);
        if (++signal == kStages) signal = 0;
      }
      if (++stage == kStages) {
        stage = 0;
        parity ^= 1;
      }
    }
    }
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    for (int k = issued < kLag ? issued : kLag; k > 0; --k) {
      if ((p & 31) == 0) mbar_arrive(full_bar + 8 * signal);
      if (++signal == kStages) signal = 0;
    }
    return;
  }

  // Consumers. Warp wq of warpgroup g holds rows 16 wq + lane / 4 (+ 8) of
  // g's 64 and columns 8 j + 2 (lane % 4) (+ 1), j = 0..31: with the
  // packed columns, units ct 64 + 8 q + 2 (lane % 4) (+ 1), q = 0..7.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int warp = tid >> 5, lane = tid & 31;
  const int g = warp >> 2, wq = warp & 3, cq = lane & 3;
  const bool pairs = (H & 1) == 0;  // (unit, unit + 1) both inside, 8 B aligned
  int stage = 0;
  uint32_t parity = 0;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
  const int ct = tile % tiles, row0 = tile / tiles * kRows;
  const int rbase = row0 + g * 64 + 16 * wq + (lane >> 2);
  const int ubase = ct * kUnits + 2 * cq;
  // c of the thread's cells, read before the products so that its latency
  // hides behind them: cin[q][hh] is units ubase + 8 q (+ 1) of row
  // rbase + 8 hh.
  float2 cin[8][2];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rbase + 8 * hh, unit = ubase + 8 * q;
      cin[q][hh] = make_float2(0.0f, 0.0f);
      if (row < P && unit < H) {
        const size_t at = static_cast<size_t>(row) * H + unit;
        if (pairs) {
          cin[q][hh] = *reinterpret_cast<const float2*>(c + at);
        } else {
          cin[q][hh].x = c[at];
          if (unit + 1 < H) cin[q][hh].y = c[at + 1];
        }
      }
    }

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  fence_acc(acc);
  int prev = -1;
  for (int k = 0; k < chunks; ++k) {
    mbar_wait(full_bar + 8 * stage, parity);
    const uint32_t a = base + stage * kStageBytes + g * 64 * kRowBytes;
    const uint32_t b = base + stage * kStageBytes + kABytes;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_m64n256k16(acc, wgmma_desc(a + s * 32), wgmma_desc(b + s * 32),
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
  if (lane == 0) mbar_arrive(empty_bar + 8 * prev);  // the tile's last stage

  // Epilogue: acc[4 (4 q + gate) + 2 hh + u] is gate `gate` of unit
  // ubase + 8 q + u of row rbase + 8 hh.
  const float* bt = bias + ct * kTileN + 2 * cq;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int unit = ubase + 8 * q;
    if (unit >= H) continue;
    float2 bv[4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
      bv[gate] = __ldg(reinterpret_cast<const float2*>(bt + 32 * q + 8 * gate));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rbase + 8 * hh;
      if (row >= P) continue;
      const size_t at = static_cast<size_t>(row) * H + unit;
      const bool two = unit + 1 < H;
      float hn[2], cn[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 2 * hh + u;
        const float gi = acc[4 * (4 * q + 0) + e] + (u ? bv[0].y : bv[0].x);
        const float gf = acc[4 * (4 * q + 1) + e] + (u ? bv[1].y : bv[1].x);
        const float go = acc[4 * (4 * q + 2) + e] + (u ? bv[2].y : bv[2].x);
        const float gg = acc[4 * (4 * q + 3) + e] + (u ? bv[3].y : bv[3].x);
        const float kept = sigmoid(gf) * (u ? cin[q][hh].y : cin[q][hh].x);
        const float added = sigmoid(gi) * tanhf(gg);
        cn[u] = kept + added;
        hn[u] = sigmoid(go) * tanhf(cn[u]);
      }
      if (pairs) {
        *reinterpret_cast<float2*>(c + at) = make_float2(cn[0], cn[1]);
        *reinterpret_cast<float2*>(h_out + at) = make_float2(hn[0], hn[1]);
      } else {
        c[at] = cn[0];
        h_out[at] = hn[0];
        if (two) {
          c[at + 1] = cn[1];
          h_out[at + 1] = hn[1];
        }
      }
      // the padded units of bf16(h) stay zero
      *reinterpret_cast<uint32_t*>(hb_out + static_cast<size_t>(row) * Hp +
                                   unit) = bf16x2(hn[0], two ? hn[1] : 0.0f);
    }
  }
  }
}

// W^T (n_pad, k_pad) bf16 row-major as a 2-D (K, N) map, read in boxes of
// 64 K x 256 columns, 128-byte swizzled.
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

}  // namespace

// xsrc: (xrows, Ep) bf16, the rows x is gathered from; tok: (P,) int64,
// or null to take row r of xsrc for row r (then xrows >= P). hb_in,
// hb_out: (P, Hp) bf16, bf16(h) before and after, two buffers; wt:
// (4 Hp, Ep + Hp) bf16, [Wx ; Wh] transposed, columns permuted and both
// parts zero-padded (ops/lstm_cell.py:pack); bias: (4 Hp,) f32 in the same
// column order; c: (P, H) f32, updated in place; h: (P, H) f32, written.
// Ep and Hp are E and H rounded up to 64. Launches on the current device.
// Returns a cudaError_t, -1 for an unsupported geometry or a device index
// of kMaxDevices or more, or -2 if W's TMA map cannot be encoded.
extern "C" int dc_lstm_cell(const void* xsrc, int xrows, const void* tok,
                            const void* hb_in, const void* wt,
                            const void* bias, void* c, void* h, void* hb_out,
                            int P, int E, int H, void* stream) {
  const int Ep = (E + kChunk - 1) / kChunk * kChunk;
  const int Hp = (H + kUnits - 1) / kUnits * kUnits;
  if (P < 1 || E < 1 || H < 1 || xrows < 1 || (tok == nullptr && xrows < P) ||
      static_cast<long long>(xrows) * Ep >= (1LL << 31) ||
      static_cast<long long>(P + kRows) * Hp >= (1LL << 31))
    return -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return -1;
  CUtensorMap map;
  if (!w_map(&map, wt, 4 * Hp, Ep + Hp)) return -2;
  // the attribute is per kernel and device: set once on each device, by
  // whichever thread launches there first (a repeat is harmless)
  static std::atomic<bool> ready[kMaxDevices];
  if (!ready[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(lstm_cell_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev].store(true, std::memory_order_release);
  }
  const int tiles = Hp / kUnits;
  const int total = (P + kRows - 1) / kRows * tiles;
  // one CTA an SM, each walking the tiles blockIdx.x + i gridDim.x
  static std::atomic<int> sms[kMaxDevices];
  int n = sms[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    sms[dev].store(n, std::memory_order_relaxed);
  }
  const int blocks = total < n ? total : n;
  lstm_cell_kernel<<<blocks, kConsumers + kProducers, kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const __nv_bfloat16*>(xsrc), xrows,
      static_cast<const long long*>(tok),
      static_cast<const __nv_bfloat16*>(hb_in),
      static_cast<const float*>(bias), static_cast<float*>(c),
      static_cast<float*>(h), static_cast<__nv_bfloat16*>(hb_out), P, H, Ep,
      Hp, tiles, total);
  return static_cast<int>(cudaGetLastError());
}
