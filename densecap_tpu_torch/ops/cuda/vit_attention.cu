// K6: the attention core of a ViTDet block with its decomposed relative
// positions. For one (image or window, head) over an hh x ww grid of
// L = hh ww tokens (row-major), with q, k, v (L, 64) in bf16 and the
// tables Rh (2 hh - 1, 64) and Rw (2 ww - 1, 64), it computes
//
//   rel_h[i, kh] = q_i . Rh[qh(i) - kh + hh - 1]     (rel_w alike, on kw)
//   o_i = softmax_j((q_i d^-0.5) . k_j + rel_h[i, kh(j)] + rel_w[i, kw(j)]) v
//
// with the unscaled q in the relative terms (detectron2's
// add_decomposed_rel_pos), and writes o token-major in bf16. The logits,
// their exponentials and the relative terms never leave the SM.
//
// Replaces no TPU kernel: the JAX package has no ViTDet trunk. Before K6
// the port folded the relative terms into cuDNN's fused attention at scale
// 1, q' = [q d^-0.5, rel_h, rel_w] against k' = [k, onehot(kh),
// onehot(kw)]: a head of 192 in place of 64 at the 64 x 64 grid (3x the
// product), with q', k' and the gathered relative product written to
// device memory and read back: 2.27 ms a global block and 0.90 ms a
// windowed one at B = 8 on an H100, where K6 takes 1.08 and 0.20.
//
// What bounds it: a global block's 4 L^2 d + 4 L hh d operations a head
// (0.42 ms at B = 8, 12 heads, L = 4096, at 989 TFLOP/s) against q, k, v
// and o read or written once (0.06 ms at 3.35 TB/s): the tensor cores,
// and as much the exponentials (one a logit, 16 a clock on an SM: at
// d = 64 about as long as the products) and the logits' f32 arithmetic.
// A windowed block (200 windows of 14 x 14) does 18x less work and is
// bound by its bytes (0.07 ms) and each window's latency.
//
// Design (Hopper wgmma, warp-specialised, persistent: one CTA an SM, each
// walking work items, an item a 128-row query tile of one (image or
// window, head)):
//   * A producer thread loads by TMA, through maps over q, k and v as they
//     lie in the qkv product's output (token-major, heads inside), the
//     tables [Rh ; Rw] once, then per item its q rows and its key tiles'
//     k and v into a ring of stages, each completing on an mbarrier and
//     released by the consumers, k after its S product and v after its
//     P v; rows past L arrive as zeros. The producer warpgroup gives its
//     registers to the consumers (setmaxnreg).
//   * Two consumer warpgroups take 64 query rows each. First, the
//     relative terms: wgmma products of their q rows with [Rh ; Rw], 64
//     table rows at a time, whose f32 results each thread scatters to its
//     own rows' rel_h and rel_w in shared memory, scaled by log2 e.
//   * Then per key tile: S = q k^T on wgmma (f32 in registers); each logit
//     becomes S d^-0.5 log2 e + rel_h + rel_w; the online softmax in f32
//     (exp2); P rounded to bf16 in registers as wgmma's A operand; O += P v
//     on wgmma with v read MN-major. A tile's S product is issued with the
//     last tile's P v, and its softmax runs while P v is under way; the
//     two warpgroups take the tensor cores in turns (named barriers), so
//     one's softmax also runs under the other's products.
//   * Two variants, picked by the grid. One-pass, for windows of up to
//     16 x 14: the whole window is one key tile of 224 keys, loaded in grid
//     order (16 grid rows by 2 grid columns a TMA box), so that a thread's
//     column j of a row holds kh = 4 (j % 4) + lane % 4 and kw = 2 (j / 4)
//     + parity: the row's 14 rel_w and 4 rel_h sit in registers and each
//     logit takes one add and one fma; q and k, v are double-buffered
//     across items. Tiled, for larger grids: 128-key tiles through 3
//     stages; where a tile is two whole grid rows (ww = 64) each row reads
//     its rel_w once a tile as pairs and its rel_h as one pair, which lifts
//     each half's maximum and exponent; elsewhere each logit finds kh = j /
//     ww and kw = j % ww.
//   * O is divided by the softmax sums, rounded to bf16 once, staged in
//     the warpgroup's q rows (swizzled) and written as 16-byte rows.
//
// Numerics: bf16 operands; the products, the relative terms, the softmax
// statistics and the output sums in f32 (exp2 by ex2.approx); o rounded
// once. Requires d = 64.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;                     // head size
constexpr int kRowBytes = kD * 2;          // one token's q, k or v: 128 B
constexpr int kMaxTable = 256;             // rows of [Rh ; Rw], padded to 64
constexpr int kMaxRelStride = 136;         // floats a row of rel_h | rel_w
constexpr int kMaxSmem = 232448;           // a block's shared memory
// 2 x 128 x 240 + 128 x 24 <= 65 536
constexpr int kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory from the 1024-aligned base: QBUF buffers of q (128 rows),
// [Rh ; Rw] (tn rows), STAGES x (k, v) tiles of BN rows, each row 128 B
// and 128-byte swizzled; the rows' relative terms (kRows x stride f32);
// the mbarriers.
template <int BN, bool kTiled>
struct Layout {
  static constexpr int NWG = 2;                    // consumer warpgroups
  static constexpr int kRows = 64 * NWG;           // query rows a CTA
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kConsumers = 128 * NWG;     // and a producer warpgroup
  // registers a consumer thread: NWG x 128 x this + 128 x 24 <= 65 536
  static constexpr int kConsumerRegs = 240;
  static constexpr int STAGES = kTiled ? 3 : 2;    // (k, v) tiles in flight
  static constexpr int QBUF = kTiled ? 1 : 2;      // q tiles in flight
  static constexpr int kTileBytes = BN * kRowBytes;
  static constexpr int kBars = 1 + 2 * QBUF + 4 * STAGES;
  __host__ __device__ static int table() { return QBUF * kQBytes; }
  __host__ __device__ static int kv(int tn) {
    return table() + tn * kRowBytes;
  }
  __host__ __device__ static int rel(int tn) {
    return kv(tn) + STAGES * 2 * kTileBytes;
  }
  __host__ __device__ static int bars(int tn, int stride) {
    return rel(tn) + kRows * stride * 4;
  }
  __host__ __device__ static int bytes(int tn, int stride) {
    return bars(tn, stride) + 8 * kBars + 1024;
  }
};

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The descriptor of v's rows as wgmma's MN-major B operand: 8-row K groups
// 1024 B apart. A 64-wide head is one swizzle atom along N, so the stride
// between atoms is never used; both offsets are given the same 1024 B.
__device__ __forceinline__ uint64_t wgmma_desc_mn(uint32_t addr) {
  return (wgmma_desc(addr) & ~(static_cast<uint64_t>(0x3FFF) << 16)) |
         (static_cast<uint64_t>(1024 >> 4) << 16);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Keeps registers that an in-flight wgmma reads from being reused before
// the wait that ends it.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[OFF .. OFF + 64) (64 x 128) = a (64 x 16) * b (16 x 128) + (acc ? d : 0),
// both operands K-major in shared memory.
template <int OFF, int M>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[M], uint64_t a,
                                             uint64_t b, int acc) {
  static_assert(OFF + 64 <= M, "accumulator out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]),
        "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "l"(a), "l"(b), "r"(acc));
}

// d[OFF .. OFF + 32) (64 x 64) = a (64 x 16) * b (16 x 64) + (acc ? d : 0),
// both operands K-major in shared memory.
template <int OFF, int M>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[M], uint64_t a,
                                             uint64_t b, int acc) {
  static_assert(OFF + 32 <= M, "accumulator out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31])
      : "l"(a), "l"(b), "r"(acc));
}

// d[OFF .. OFF + 48) (64 x 96) = a (64 x 16) * b (16 x 96) + (acc ? d : 0),
// both operands K-major in shared memory.
template <int OFF, int M>
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[M], uint64_t a,
                                             uint64_t b, int acc) {
  static_assert(OFF + 48 <= M, "accumulator out of range");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64) = a (64 x 16, bf16 pairs in registers, wgmma's A fragment)
// * b (16 x 64) + (acc ? d : 0); b MN-major in shared memory (its rows are K).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// s[0 .. BN/2) = q (64 x 16 slice at ks) k^T over the tile's BN keys, in
// wgmma chunks of 128 and 96 keys.
template <int BN, int OFF = 0>
__device__ __forceinline__ void qk_chunks(float (&s)[BN / 2], uint64_t a,
                                          uint32_t k_s, int acc) {
  if constexpr (BN - OFF >= 128) {
    wgmma_ss_n128<OFF / 2>(s, a, wgmma_desc(k_s + OFF * kRowBytes), acc);
    qk_chunks<BN, OFF + 128>(s, a, k_s, acc);
  } else if constexpr (BN - OFF > 0) {
    static_assert(BN - OFF == 96, "key tiles are 128 + 128 i + 96 j wide");
    wgmma_ss_n96<OFF / 2>(s, a, wgmma_desc(k_s + OFF * kRowBytes), acc);
  }
}

// S (64 x BN) = q (the warpgroup's 64 rows) k^T, d = 64 in 4 steps of 16.
template <int BN>
__device__ __forceinline__ void qk_product(float (&s)[BN / 2], uint32_t q_s,
                                           uint32_t k_s) {
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)
    qk_chunks<BN>(s, wgmma_desc(q_s + ks * 32), k_s + ks * 32, ks);
}

// O (64 x 64) = P (64 x BN, bf16 pairs in registers) v (BN x 64) + (acc ?
// O : 0).
template <int BN>
__device__ __forceinline__ void pv_product(float (&o)[32],
                                           const uint32_t (&p)[BN / 4],
                                           uint32_t v_s, int acc) {
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks) {
    const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2],
                           p[4 * ks + 3]};
    wgmma_rs_n64_tb(o, a, wgmma_desc_mn(v_s + ks * 16 * kRowBytes),
                    acc | ks);
  }
}

// What a consumer thread needs of its two rows (r and r + 8 of its warp's
// 16) across the tiles.
struct Rows {
  const float* rel[2];  // the rows' rel_h at [kh], rel_w at [wo + kw]
  float m[2];           // running max, log2 domain
  float l[2];           // running sum of the thread's own columns
};

// The online softmax over the tile's logits s (log2 domain, in place): s
// becomes exp2(logit - max), alpha the factor that brings the sums and O
// kept so far to the new max. `lift[i][h]` is added to every logit of row
// i in half h of the columns before the max and the exponent (0 where the
// logits are whole). The two rows run side by side and the maxima and
// sums in several chains, so the exponentials issue back to back.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], Rows& rw,
                                               float (&alpha)[2],
                                               const float (&lift)[2][2]) {
  constexpr int J = BN / 8, H = J / 2;  // column blocks, in each half
  float mx[2][2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[i][h][0] = mx[i][h][1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float& m = mx[i][j >= H][j & 1];
      m = fmaxf(m, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    }
  float m[2], c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    m[i] = fmaxf(rw.m[i],
                 fmaxf(fmaxf(mx[i][0][0], mx[i][0][1]) + lift[i][0],
                       fmaxf(mx[i][1][0], mx[i][1][1]) + lift[i][1]));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
#pragma unroll
  for (int i = 0; i < 2; ++i)
    m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    alpha[i] = ex2(rw.m[i] - m[i]);
    rw.m[i] = m[i];
    c[i][0] = lift[i][0] - m[i];
    c[i][1] = lift[i][1] - m[i];
  }
  float sum[2][4] = {};
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float& x = s[4 * j + 2 * i + u];
        x = ex2(x + c[i][j >= H]);
        sum[i][(2 * j + u) & 3] += x;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    rw.l[i] = rw.l[i] * alpha[i] +
              ((sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]));
}

// O (the thread's two rows) brought to the rows' new max.
__device__ __forceinline__ void rescale(float (&o)[32], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= alpha[i];
      o[4 * j + 2 * i + 1] *= alpha[i];
    }
}

// P in bf16 as wgmma's A fragments: p[2 j + i] holds row i's columns
// 8 j + 2 t4 and + 1, so k-step ks reads p[4 ks .. 4 ks + 3].
// Tiled: key tile t's softmax step (`online_softmax`) on its logits
// S d^-0.5 log2 e + rel_h + rel_w (the terms already scaled by log2 e),
// keys past L at -inf. Where a tile is grid rows 2t and 2t + 1 (ww =
// BN / 2), column c has kw = c % ww and each half of the columns one
// rel_h a row, which enters as the half's lift.
template <int BN, bool kAligned>
__device__ __forceinline__ void tile_softmax(float (&s)[BN / 2], Rows& rw,
                                             float (&alpha)[2], int t,
                                             int L, int ww, int wo,
                                             float inv_ww, float scale,
                                             int t4) {
  const int key0 = t * BN;
  float lift[2][2] = {};
  if constexpr (kAligned) {
    constexpr int H = BN / 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 rh = *reinterpret_cast<const float2*>(rw.rel[i] + 2 * t);
      lift[i][0] = rh.x;
      lift[i][1] = rh.y;
    }
#pragma unroll
    for (int j = 0; j < H; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 w = *reinterpret_cast<const float2*>(rw.rel[i] + wo +
                                                          8 * j + 2 * t4);
        float* lo = s + 4 * j + 2 * i;
        float* hi = s + 4 * (j + H) + 2 * i;
        lo[0] = fmaf(lo[0], scale, w.x);
        lo[1] = fmaf(lo[1], scale, w.y);
        hi[0] = fmaf(hi[0], scale, w.x);
        hi[1] = fmaf(hi[1], scale, w.y);
      }
    if (key0 + BN > L) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (key0 + 8 * j + 2 * t4 + u >= L)
              s[4 * j + 2 * i + u] = -INFINITY;
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = key0 + 8 * j + 2 * t4 + u;
        const int cc = c < L ? c : L - 1;
        const int kh = static_cast<int>((cc + 0.5f) * inv_ww);
        const int kw = cc - kh * ww;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[4 * j + 2 * i + u];
          x = c < L ? fmaf(x, scale, rw.rel[i][kh] + rw.rel[i][wo + kw])
                    : -INFINITY;
        }
      }
  }
  online_softmax<BN>(s, rw, alpha, lift);
}

// One-pass: the logits of the whole window, its keys loaded in grid order
// (column block j = 4 pw + qd holds kh = 4 qd + t4 and kw = 2 pw + u), so
// each logit's terms are registers: rh[i][qd] = rel_h[kh], rw[i][kw] =
// rel_w[kw], -inf past the grid.
template <int BN>
__device__ __forceinline__ void window_logits(float (&s)[BN / 2],
                                              const float (&rh)[2][4],
                                              const float (&rw)[2][BN / 16],
                                              float scale) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float& x = s[4 * j + 2 * i + u];
        x = fmaf(x, scale, rh[i][j % 4] + rw[i][2 * (j / 4) + u]);
      }
}

template <int BN>
__device__ __forceinline__ void to_bf16(const float (&s)[BN / 2],
                                        uint32_t (&p)[BN / 4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      p[2 * j + i] = bf16x2(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
}

// Row i's relative terms from G = q [Rh ; Rw]^T, columns c0 .. c0 + 63 of
// it (the thread's: 8 j + 2 t4 + u), scaled by log2 e: rel_h[kh] is
// G[i, qh(i) - kh + hh - 1] and rel_w[kw] G[i, 2 hh - 1 + qw(i) - kw +
// ww - 1].
__device__ __forceinline__ void scatter_rel(const float (&g)[32], int c0,
                                            float* (&r)[2],
                                            const int (&qh)[2],
                                            const int (&qw)[2], int hh,
                                            int ww, int wo, int th, int tw,
                                            int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = c0 + 8 * j + 2 * t4 + u;
        const float val = g[4 * j + 2 * i + u] * kLog2e;
        if (c < th) {
          const int kh = qh[i] + hh - 1 - c;
          if (static_cast<unsigned>(kh) < static_cast<unsigned>(hh))
            r[i][kh] = val;
        } else if (c < th + tw) {
          const int kw = qw[i] + ww - 1 - (c - th);
          if (static_cast<unsigned>(kw) < static_cast<unsigned>(ww))
            r[i][wo + kw] = val;
        }
      }
}

// Named barriers 1 and 2 take the two consumer warpgroups' products in
// turns: warpgroup w issues its products after bar.sync 1 + w and then
// lets the other go, so one's softmax runs under the other's products.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
}

template <int NWG>
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(1 + (wg + 1) % NWG) : "memory");
}

template <int BN, bool kTiled, bool kAligned>
__global__ void __launch_bounds__(384, 1)
vit_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap tmap,
                     __nv_bfloat16* __restrict__ out, int N, int L, int hh,
                     int ww, int heads, int tn, int stride, float scale) {
  using Lay = Layout<BN, kTiled>;
  constexpr int NWG = Lay::NWG;
  constexpr int kTile = Lay::kTileBytes, kRows = Lay::kRows;
  constexpr int kQBytes = Lay::kQBytes, kConsumers = Lay::kConsumers;
  constexpr int STAGES = Lay::STAGES, QBUF = Lay::QBUF;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t t_s = base + Lay::table(), kv_s = base + Lay::kv(tn);
  float* const rel = reinterpret_cast<float*>(gbase + Lay::rel(tn));
  // mbarriers: the tables; each q buffer's load and release; k and v of
  // each stage, loaded and released
  const uint32_t tbar = base + Lay::bars(tn, stride);
  const uint32_t qbar = tbar + 8, qfree = qbar + 8 * QBUF;
  const uint32_t kbar = qfree + 8 * QBUF, vbar = kbar + 8 * STAGES;
  const uint32_t kfree = vbar + 8 * STAGES, vfree = kfree + 8 * STAGES;

  const int tid = threadIdx.x;
  const int qtiles = (L + kRows - 1) / kRows;
  const int items = qtiles * heads * N;
  const int tiles = (L + BN - 1) / BN;

  if (tid == 0) {
    mbar_init(tbar, 1);
    for (int b = 0; b < QBUF; ++b) {
      mbar_init(qbar + 8 * b, 1);
      mbar_init(qfree + 8 * b, 4 * NWG);  // every consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kbar + 8 * s, 1);
      mbar_init(vbar + 8 * s, 1);
      mbar_init(kfree + 8 * s, 4 * NWG);
      mbar_init(vfree + 8 * s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer: the tables once, then per item (a query tile of one
    // head of one image or window) its q rows and its key tiles, running
    // ahead into free buffers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (tid != kConsumers) return;
    mbar_expect_tx(tbar, tn * kRowBytes);
    tma_load_2d(t_s, &tmap, 0, 0, tbar);
    // An item's q follows its first key tiles, which need only the
    // previous item's last tiles released, not the whole item done.
    const int q_after = (tiles < STAGES ? tiles : STAGES) - 1;
    int k = 0, g = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
      const int qt = item % qtiles, hn = item / qtiles;
      const int head = hn % heads, n = hn / heads;
      const int qb = k % QBUF;
      for (int t = 0; t < tiles; ++t, ++g) {
        const int s = g % STAGES;
        // stage s last held tile g - STAGES: its k released after its S
        // product, its v after its P v
        const uint32_t dst = kv_s + s * 2 * kTile;
        const int ph = ((g / STAGES) - 1) & 1;
        if (g >= STAGES) mbar_wait(kfree + 8 * s, ph);
        mbar_expect_tx(kbar + 8 * s, kTile);
        if constexpr (kTiled) {
          tma_load_4d(dst, &kmap, 0, head, t * BN, n, kbar + 8 * s);
        } else {
          // the window in grid order: per pair of grid columns, 16 grid
          // rows x 2 columns, rows past the grid zero
#pragma unroll
          for (int pw = 0; pw < BN / 32; ++pw)
            tma_load_5d(dst + pw * 32 * kRowBytes, &kmap, 0, head, 2 * pw, 0,
                        n, kbar + 8 * s);
        }
        if (g >= STAGES) mbar_wait(vfree + 8 * s, ph);
        mbar_expect_tx(vbar + 8 * s, kTile);
        if constexpr (kTiled) {
          tma_load_4d(dst + kTile, &vmap, 0, head, t * BN, n, vbar + 8 * s);
        } else {
#pragma unroll
          for (int pw = 0; pw < BN / 32; ++pw)
            tma_load_5d(dst + kTile + pw * 32 * kRowBytes, &vmap, 0, head,
                        2 * pw, 0, n, vbar + 8 * s);
        }
        if (t == q_after) {
          if (k >= QBUF) mbar_wait(qfree + 8 * qb, ((k / QBUF) - 1) & 1);
          mbar_expect_tx(qbar + 8 * qb, kQBytes);
          tma_load_4d(base + qb * kQBytes, &qmap, 0, head, qt * kRows, n,
                      qbar + 8 * qb);
        }
      }
    }
    return;
  }

  // Consumers. Warp wq of warpgroup wg holds rows 16 wq + g and + 8 of
  // wg's 64 (g = lane / 4) and, of every wgmma result, columns 8 j + 2 t4
  // and + 1 (t4 = lane % 4).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(Lay::kConsumerRegs));
  const int warp = tid >> 5, lane = tid & 31;
  // warp-uniform by a shuffle, so that the q descriptors built from it
  // sit in uniform registers and never stall the products
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int wq = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int row0 = wg * 64 + 16 * wq + g;  // the first row, in the CTA
  const int wo = (hh + 3) & ~3;            // rel_w's offset in a row
  const int th = 2 * hh - 1, tw = 2 * ww - 1;
  const float inv_ww = 1.0f / static_cast<float>(ww);
  float* const r0 = rel + row0 * stride;
  float* const r1 = rel + (row0 + 8) * stride;
  Rows rw;
  rw.rel[0] = r0;
  rw.rel[1] = r1;
  if (wg == NWG - 1) turn_pass<NWG>(wg);  // warpgroup 0 issues first

  mbar_wait(tbar, 0);
  int k = 0, gt = 0;  // items and key tiles this CTA has taken
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int qt = item % qtiles, hn = item / qtiles;
    const int head = hn % heads, n = hn / heads, q0 = qt * kRows;
    const int qb = k % QBUF;
    const uint32_t q_s = base + qb * kQBytes;
    const uint32_t qw_s = q_s + wg * 64 * kRowBytes;
    mbar_wait(qbar + 8 * qb, (k / QBUF) & 1);

    // The relative terms of the rows: G = q [Rh ; Rw]^T, 64 table rows a
    // product; row i's rel_h[kh] is G[i, qh(i) - kh + hh - 1] and its
    // rel_w[kw] G[i, 2 hh - 1 + qw(i) - kw + ww - 1].
    {
      float* r[2] = {r0, r1};
      int qh[2], qw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = q0 + row0 + 8 * i;
        qh[i] = qi / ww;
        qw[i] = qi - qh[i] * ww;
      }
      for (int c0 = 0; c0 < th + tw; c0 += 64) {
        float gp[32];
        fence_acc(gp);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kD / 16; ++ks)
          wgmma_ss_n64<0>(gp, wgmma_desc(qw_s + ks * 32),
                          wgmma_desc(t_s + c0 * kRowBytes + ks * 32), ks);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(gp);
        scatter_rel(gp, c0, r, qh, qw, hh, ww, wo, th, tw, t4);
      }
      __syncwarp();  // a row's terms are written and read by one warp
    }
    // One-pass: the rows' terms of the window's grid columns and of their
    // own four grid rows, in registers, -inf past the grid.
    float rh[2][4], rwr[2][kTiled ? 1 : BN / 16];
    if constexpr (!kTiled) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int qd = 0; qd < 4; ++qd) {
          const int kh = 4 * qd + t4;
          rh[i][qd] = kh < hh ? rw.rel[i][kh] : -INFINITY;
        }
#pragma unroll
        for (int kw = 0; kw < BN / 16; ++kw)
          rwr[i][kw] = kw < ww ? rw.rel[i][wo + kw] : -INFINITY;
      }
    }

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    rw.m[0] = rw.m[1] = -INFINITY;
    rw.l[0] = rw.l[1] = 0.0f;
    float s[BN / 2];
    uint32_t p0[BN / 4], p1[BN / 4];  // tile t's P is in p[t % 2]
    float alpha[2];

    // Tile 0: S, the logits, the softmax, P.
    {
      const int st = gt % STAGES;
      mbar_wait(kbar + 8 * st, (gt / STAGES) & 1);
      turn_wait(wg);
      fence_acc(s);
      wgmma_fence();
      qk_product<BN>(s, qw_s, kv_s + st * 2 * kTile);
      wgmma_commit();
      fence_acc(s);
      turn_pass<NWG>(wg);
      wgmma_wait<0>();
      fence_acc(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(kfree + 8 * st);
      if constexpr (kTiled) {
        tile_softmax<BN, kAligned>(s, rw, alpha, 0, L, ww, wo, inv_ww, scale,
                                   t4);
      } else {
        window_logits<BN>(s, rh, rwr, scale);
        const float none[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
        online_softmax<BN>(s, rw, alpha, none);
      }
      to_bf16<BN>(s, p0);
    }
    // Tiled, tile t: once P v of tile t - 2 is done, O is brought to tile
    // t - 1's max; S of tile t and P v of tile t - 1 are issued, and the
    // softmax of tile t runs under them into the other P buffer. The
    // mbarrier waits are loops, across which the SASS scheduler does not
    // move code: the second keeps O's rescale ahead of the products.
    if constexpr (kTiled) {
      auto body = [&](int t, uint32_t (&pp)[BN / 4], uint32_t (&pn)[BN / 4]) {
        const int gc = gt + t, st = gc % STAGES, sp = (gc - 1) % STAGES;
        mbar_wait(kbar + 8 * st, (gc / STAGES) & 1);
        wgmma_wait<0>();  // P v of tile t - 2
        fence_acc(o);
        fence_regs(pn);
        if (t >= 2) {
          __syncwarp();
          if (lane == 0) mbar_arrive(vfree + 8 * ((gc - 2) % STAGES));
        }
        rescale(o, alpha);
        fence_acc(o);
        mbar_wait(vbar + 8 * sp, ((gc - 1) / STAGES) & 1);
        turn_wait(wg);
        fence_acc(s);
        fence_acc(o);
        fence_regs(pp);
        wgmma_fence();
        qk_product<BN>(s, qw_s, kv_s + st * 2 * kTile);
        wgmma_commit();
        // a stage of its own for P v, so that S may be read once its own
        // group is done
        wgmma_fence();
        pv_product<BN>(o, pp, kv_s + sp * 2 * kTile + kTile, 1);
        wgmma_commit();
        fence_acc(s);
        fence_acc(o);
        fence_regs(pp);
        turn_pass<NWG>(wg);
        wgmma_wait<1>();  // S of tile t is in; P v of t - 1 may still run
        fence_acc(s);
        __syncwarp();
        if (lane == 0) mbar_arrive(kfree + 8 * st);
        tile_softmax<BN, kAligned>(s, rw, alpha, t, L, ww, wo, inv_ww, scale,
                                   t4);
        to_bf16<BN>(s, pn);
      };
      int t = 1;
      for (; t + 1 < tiles; t += 2) {
        body(t, p0, p1);
        body(t + 1, p1, p0);
      }
      if (t < tiles) body(t, p0, p1);
    }
    // The last tile's P v, into a sum of its own that joins O (brought to
    // the last max) after the wait, so no rescale precedes the products.
    {
      const int gl = gt + tiles - 1, sl = gl % STAGES;
      mbar_wait(vbar + 8 * sl, (gl / STAGES) & 1);
      if (kTiled && tiles > 1) {
        wgmma_wait<0>();  // P v of the tile before
        fence_acc(o);
        __syncwarp();
        if (lane == 0) mbar_arrive(vfree + 8 * ((gl - 1) % STAGES));
      }
      float ol[32];
      turn_wait(wg);
      fence_acc(ol);
      fence_regs(p0);
      fence_regs(p1);
      wgmma_fence();
      if (kTiled && ((tiles - 1) & 1))
        pv_product<BN>(ol, p1, kv_s + sl * 2 * kTile + kTile, 0);
      else
        pv_product<BN>(ol, p0, kv_s + sl * 2 * kTile + kTile, 0);
      wgmma_commit();
      fence_acc(ol);
      fence_regs(p0);
      fence_regs(p1);
      turn_pass<NWG>(wg);
      wgmma_wait<0>();
      fence_acc(ol);
      fence_regs(p0);
      fence_regs(p1);
      __syncwarp();
      if (lane == 0) mbar_arrive(vfree + 8 * sl);
      rescale(o, alpha);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] += ol[i];
    }
    gt += tiles;

    // o / l in bf16, staged in the warpgroup's q rows (its products are
    // done) with the 16-byte chunks swizzled by row, then 16-byte stores;
    // then the q buffer is free.
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float sum = rw.l[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[i] = 1.0f / sum;
    }
    unsigned char* const stage = gbase + qb * kQBytes + wg * 64 * kRowBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * wq + g + 8 * i;
        *reinterpret_cast<uint32_t*>(stage + row * kRowBytes +
                                     ((j ^ (row & 7)) << 4) + 4 * t4) =
            bf16x2(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
      }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int row = 16 * wq + 4 * it + (lane >> 3), c = lane & 7;
      const int qi = q0 + wg * 64 + row;
      if (qi < L) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            stage + row * kRowBytes + ((c ^ (row & 7)) << 4));
        *reinterpret_cast<uint4*>(
            out + ((static_cast<size_t>(n) * L + qi) * heads + head) * kD +
            8 * c) = val;
      }
    }
    // the buffer's next TMA write follows these generic reads and writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(qfree + 8 * qb);
  }
  if (wg == 0) turn_wait(0);  // the last warpgroup's last pass
}

// A 4-D map over q, k or v as (d, heads, L, N) with the given element
// strides of a head, a token and an image, read in boxes of one head's
// `rows` tokens, 128-byte swizzled; rows past L read as zeros.
bool qkv_map(CUtensorMap* map, const void* ptr, int N, int L, int heads,
             long long s_head, long long s_tok, long long s_img, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_tok) * 2,
                                 static_cast<cuuint64_t>(s_img) * 2};
  const cuuint32_t box[4] = {kD, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 5-D map over k or v as (d, heads, ww, hh, N), read in boxes of one
// head's 16 grid rows x 2 grid columns (32 rows of 128 B, grid row major),
// 128-byte swizzled; rows and columns past the grid read as zeros.
bool grid_map(CUtensorMap* map, const void* ptr, int N, int hh, int ww,
              int heads, long long s_head, long long s_tok, long long s_img) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {
      static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(heads),
      static_cast<cuuint64_t>(ww), static_cast<cuuint64_t>(hh),
      static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_tok) * 2,
                                 static_cast<cuuint64_t>(s_tok) * ww * 2,
                                 static_cast<cuuint64_t>(s_img) * 2};
  const cuuint32_t box[5] = {kD, 1, 2, 16, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (tn, 64) table [Rh ; Rw ; 0] as one box.
bool table_map(CUtensorMap* map, const void* ptr, int tn) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(tn)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kRowBytes)};
  const cuuint32_t box[2] = {kD, static_cast<cuuint32_t>(tn)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, bool kTiled, bool kAligned>
int launch(const void* q, const void* k, const void* v, long long s_head,
           long long s_tok, long long s_img, const void* table, int tn,
           void* out, int N, int L, int hh, int ww, int heads, int stride,
           float scale, int dev, cudaStream_t stream) {
  using Lay = Layout<BN, kTiled>;
  constexpr int kRows = Lay::kRows;
  const int smem = Lay::bytes(tn, stride);
  if (smem > kMaxSmem) return -1;
  CUtensorMap qm, km, vm, tm;
  const bool kv_ok =
      kTiled ? qkv_map(&km, k, N, L, heads, s_head, s_tok, s_img, BN) &&
                   qkv_map(&vm, v, N, L, heads, s_head, s_tok, s_img, BN)
             : grid_map(&km, k, N, hh, ww, heads, s_head, s_tok, s_img) &&
                   grid_map(&vm, v, N, hh, ww, heads, s_head, s_tok, s_img);
  if (!qkv_map(&qm, q, N, L, heads, s_head, s_tok, s_img, kRows) || !kv_ok ||
      !table_map(&tm, table, tn))
    return -2;
  auto kernel = vit_attention_kernel<BN, kTiled, kAligned>;
  // the attribute is per kernel and device: set once on each device, by
  // whichever thread launches there first (a repeat is harmless)
  static std::atomic<bool> ready[kMaxDevices];
  static std::atomic<int> sms[kMaxDevices];
  if (!ready[dev].load(std::memory_order_acquire)) {
    int n = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    sms[dev].store(n, std::memory_order_relaxed);
    ready[dev].store(true, std::memory_order_release);
  }
  // one CTA an SM, each walking the items blockIdx.x + i gridDim.x
  const long long items =
      static_cast<long long>((L + kRows - 1) / kRows) * heads * N;
  if (items >= (1LL << 31)) return -1;
  const int n_sm = sms[dev].load(std::memory_order_relaxed);
  const int grid = items < n_sm ? static_cast<int>(items) : n_sm;
  kernel<<<grid, 128 * (Lay::NWG + 1), smem, stream>>>(
      qm, km, vm, tm, static_cast<__nv_bfloat16*>(out), N, L, hh, ww, heads,
      tn, stride, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (N, L, heads, 64) bf16 views with one set of element strides
// (s_img, s_tok, s_head; the last dimension contiguous), each 16-byte
// aligned with strides of a multiple of 8; table: (tn, 64) bf16
// contiguous, [Rh ; Rw] then zero rows to tn, a multiple of 64; out:
// (N, L, heads, 64) bf16 contiguous. The grid is hh x ww = L, row-major;
// scale is d^-0.5. Launches on the current device. Returns a cudaError_t,
// -1 for a geometry K6 does not take (its tables or relative terms past
// shared memory) or a device index of kMaxDevices or more, or -2 if a TMA
// map cannot be encoded.
extern "C" int dc_vit_attention(const void* q, const void* k, const void* v,
                                long long s_img, long long s_tok,
                                long long s_head, const void* table, int tn,
                                void* out, int N, int L, int hh, int ww,
                                int heads, float scale, void* stream) {
  const int wo = (hh + 3) & ~3;
  const int stride = (wo + ww + 31) / 32 * 32 + 8;
  const int rows = 2 * hh - 1 + 2 * ww - 1;
  if (N < 1 || heads < 1 || hh < 1 || ww < 1 || L != hh * ww ||
      stride > kMaxRelStride || tn % 64 != 0 || tn < rows || tn > kMaxTable ||
      s_head % 8 != 0 || s_tok % 8 != 0 || s_img % 8 != 0)
    return -1;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sc = scale * kLog2e;
  // one-pass: a window of up to 16 x 14 in one key tile of 16 grid rows x
  // 14 grid columns; tiled beyond
  if (hh <= 16 && ww <= 14)
    return launch<224, false, false>(q, k, v, s_head, s_tok, s_img, table, tn, out,
                              N, L, hh, ww, heads, stride, sc, dev, st);
  // tiled: a key tile of 128 is two grid rows where ww = 64
  if (2 * ww == 128)
    return launch<128, true, true>(q, k, v, s_head, s_tok, s_img, table, tn,
                                   out, N, L, hh, ww, heads, stride, sc, dev,
                                   st);
  return launch<128, true, false>(q, k, v, s_head, s_tok, s_img, table, tn,
                                  out, N, L, hh, ww, heads, stride, sc, dev,
                                  st);
}

