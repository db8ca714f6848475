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
// B = 8, 720 px) never reaches device memory; the conv's f32 sums go
// through shared memory straight into the pooled epilogue. What bounds it:
// the conv's 306 GFLOP per stage at B = 8, 720 px.
//
// bf16 design (tensor cores, WMMA bf16 16x16x16, f32 accumulators): one
// block of 8 warps per (image, pooled row, strip of 32 pooled columns),
// i.e. an implicit GEMM of M = 2 conv rows x 64 conv columns = 128 pixels
// by N = C output channels by K = 9 taps x C input channels.
//   * The 4-row x 66-column x C input halo is staged once in shared
//     memory (zero outside the image: SAME padding), each pixel padded to
//     C + 16 elements so the fragment loads spread over the banks.
//   * Per tap the C x C weight slice is staged in shared memory; each warp
//     owns 16 pixels and all C/16 output-channel fragments, and walks the
//     C/16 k-steps of the tap.
//   * Epilogue: the f32 sums go to shared memory (reusing the halo), and
//     each pooled output reads its four sums and, per sum, rounds to bf16,
//     adds the bf16 bias (rounded again, as a bf16 + bf16 add does), takes
//     ReLU and the extent mask (row < eh, col < ew); then the 2x2 max and
//     the mask at floor(eh/2), floor(ew/2). A trailing odd row or column
//     is never read, as max_pool2d floors.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kConvCols = 64;               // conv columns per block (bf16)
constexpr int kPoolCols = kConvCols / 2;    // pooled columns per block
constexpr int kHaloCols = kConvCols + 2;

template <int C>
struct Bf16Layout {
  static constexpr int kPitch = C + 16;     // bf16 elements per staged pixel
  static constexpr int kAccPitch = C + 4;   // floats per staged sum row
  static constexpr int kHaloBytes = 4 * kHaloCols * kPitch * 2;
  static constexpr int kWeightBytes = C * kPitch * 2;
  static constexpr int kSmem = kHaloBytes + kWeightBytes;
  static_assert(2 * kConvCols * kAccPitch * 4 <= kHaloBytes,
                "the sums reuse the halo's shared memory");
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
conv_pool_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wt,
                      const __nv_bfloat16* __restrict__ bias,
                      const float* __restrict__ ext, int H, int W,
                      __nv_bfloat16* __restrict__ out) {
  using L = Bf16Layout<C>;
  constexpr int kVec = C / 8;  // 16-byte vectors per pixel
  constexpr int kNT = C / 16;  // output-channel fragments
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L::kHaloBytes);

  const int strip = blockIdx.x;
  const int p = blockIdx.y;  // pooled row: conv rows 2p, 2p + 1
  const int b = blockIdx.z;
  const int c0 = strip * kConvCols;
  const int tid = threadIdx.x;
  const int Ho = H / 2, Wo = W / 2;

  // input rows 2p-1 .. 2p+2, columns c0-1 .. c0+64
  for (int v = tid; v < 4 * kHaloCols * kVec; v += blockDim.x) {
    const int pix = v / kVec, vec = v % kVec;
    const int rr = pix / kHaloCols, cc = pix % kHaloCols;
    const int row = 2 * p - 1 + rr, col = c0 - 1 + cc;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row >= 0 && row < H && col >= 0 && col < W)
      val = *reinterpret_cast<const uint4*>(
          x + (((size_t)b * H + row) * W + col) * C + vec * 8);
    *reinterpret_cast<uint4*>(xs + pix * L::kPitch + vec * 8) = val;
  }

  const int warp = tid >> 5;
  const int wr = warp / 4;         // conv row of this warp's pixels
  const int wc = (warp % 4) * 16;  // first conv column of its 16 pixels
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kNT];
#pragma unroll
  for (int n = 0; n < kNT; ++n) wmma::fill_fragment(acc[n], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      fb;

  for (int t = 0; t < 9; ++t) {
    const int dy = t / 3, dx = t % 3;
    __syncthreads();  // the previous tap's weights are consumed
    for (int v = tid; v < C * kVec; v += blockDim.x) {
      const int ci = v / kVec, vec = v % kVec;
      *reinterpret_cast<uint4*>(ws + ci * L::kPitch + vec * 8) =
          *reinterpret_cast<const uint4*>(wt + ((size_t)t * C + ci) * C +
                                          vec * 8);
    }
    __syncthreads();
    const __nv_bfloat16* arow =
        xs + ((wr + dy) * kHaloCols + wc + dx) * L::kPitch;
#pragma unroll
    for (int k = 0; k < C; k += 16) {
      wmma::load_matrix_sync(fa, arow + k, L::kPitch);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        wmma::load_matrix_sync(fb, ws + k * L::kPitch + n * 16, L::kPitch);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }

  __syncthreads();  // every warp is done with the halo
  float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int n = 0; n < kNT; ++n)
    wmma::store_matrix_sync(cs + (wr * kConvCols + wc) * L::kAccPitch + n * 16,
                            acc[n], L::kAccPitch, wmma::mem_row_major);
  __syncthreads();

  const float eh = ext[2 * b], ew = ext[2 * b + 1];
  const bool prow_ok = (float)p < floorf(eh * 0.5f);
  const float fw = floorf(ew * 0.5f);
  for (int i = tid; i < kPoolCols * C; i += blockDim.x) {
    const int j = i / C, ch = i % C;
    const int pc = strip * kPoolCols + j;
    if (pc >= Wo) break;  // i grows with j
    const float bv = __bfloat162float(bias[ch]);
    float m = 0.0f;  // every candidate is >= 0 after ReLU and the mask
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
#pragma unroll
      for (int dc = 0; dc < 2; ++dc) {
        const int row = 2 * p + dr, col = 2 * pc + dc;
        float y = bf16_round(cs[(dr * kConvCols + 2 * j + dc) * L::kAccPitch +
                                ch]);
        y = fmaxf(bf16_round(y + bv), 0.0f);
        if (!((float)row < eh && (float)col < ew)) y = 0.0f;
        m = fmaxf(m, y);
      }
    }
    if (!(prow_ok && (float)pc < fw)) m = 0.0f;
    out[(((size_t)b * Ho + p) * Wo + pc) * C + ch] = __float2bfloat16_rn(m);
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

template <int C>
int launch_bf16(const void* x, const void* wt, const void* bias,
                const void* ext, int B, int H, int W, void* out,
                cudaStream_t s) {
  using L = Bf16Layout<C>;
  static bool ready = false;  // the attribute is per kernel, set once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_pool_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  const int Wo = W / 2;
  dim3 grid((Wo + kPoolCols - 1) / kPoolCols, H / 2, B);
  conv_pool_bf16_kernel<C><<<grid, kWarps * 32, L::kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wt),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const float*>(ext),
      H, W, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_f32(const void* x, const void* wt, const void* bias,
               const void* ext, int B, int H, int W, void* out,
               cudaStream_t s) {
  constexpr int kSmem = 4 * kF32HaloCols * C * 4;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_pool_f32_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
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
// wt: (3, 3, C, C) [dy][dx][ci][co] in the same dtype; bias: (C,) same
// dtype; ext: (B, 2) f32 per-image (eh, ew). out: (B, H/2, W/2, C).
// C must be 64 or 128, H and W >= 2. Returns a cudaError_t, or -1 for an
// unsupported geometry.
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
