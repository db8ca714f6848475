// K2: RoI align forward, a direct 4-tap bilinear gather over
// channels-last features.
//
// Replaces densecap_tpu/ops/pallas/roi_align_kernel.py:roi_align_pallas
// (_kernel). The TPU kernel builds dense tent-weight matrices and runs two
// MXU contractions so that the gather becomes matrix work; on Hopper the
// gather itself is cheap, so each output sample reads its four
// neighbouring feature rows directly.
//
// What bounds it on the H100: the output. At the flagship shape (8 images
// x 1000 boxes x 7 x 7 x 512 f32) it writes 803 MB, while the feature maps
// it reads (8 x 45 x 45 x 512 f32 = 33 MB) fit in the 50 MB L2: 836 MB
// at 3.35 TB/s is 0.25 ms. What the design does about it:
//   * one block per (box, output row), 56 000 blocks at that shape, so
//     every SM holds many; a thread owns 4 consecutive channels (one
//     16-byte load or store), 128 threads cover C = 512;
//   * the output streams past L2 with evict-first stores (st.global.cs),
//     and the feature taps load with an L2 evict_last policy, so the 33 MB
//     map stays resident instead of being pushed out by 803 MB of output;
//   * along an output row the rows-first lerp of a feature column,
//     v(x) = f[y0,x](1-fy) + f[y1,x]fy, serves both neighbouring samples
//     that tap column x, so a column is read from L2 once per row, not
//     twice (the arithmetic is the same, so the result is too);
//   * C % 4 != 0 or a feature base that is not 16-byte aligned takes the
//     same kernel with one channel per thread.
//
// Numerics follow densecap_tpu/ops/roi_align.py:roi_align exactly: sample
// positions (yf, xf) come from the wrapper's _sample_coords, indices are
// i0 = clamp(floor(p), 0, size - 1), i1 = clamp(i0 + 1, 0, size - 1)
// against the image's CROPPED feature extent, and the lerps run rows
// first, then columns: r0 = f[y0,x0](1-fy) + f[y1,x0]fy,
// r1 = f[y0,x1](1-fy) + f[y1,x1]fy, out = r0(1-fx) + r1 fx.
//
// K2b, the backward, is two launches (the JAX package gets both from
// autodiff of the gather; the TPU kernel has no backward):
//   * dc_roi_align_bwd_feats: the feature gradient, a scatter-add of the
//     four taps with weights (1-fy)(1-fx), fy(1-fx), (1-fy)fx, fy fx. One
//     block per box, threads over C, f32 atomicAdd (coalesced over C). A
//     clamped tap with i0 == i1 adds twice into one cell, as autodiff
//     does. Bound by the atomics into the feature map (33 MB at the
//     training shape, L2-resident) and the read of the upstream gradient.
//   * dc_roi_align_bwd_coords: the gradient of the sample positions,
//     d out / d yf = (1-fx)(f[y1,x0]-f[y0,x0]) + fx(f[y1,x1]-f[y0,x1])
//     and d out / d xf = (1-fy)(f[y0,x1]-f[y0,x0]) + fy(f[y1,x1]-f[y1,x0])
//     (floor has zero gradient, so d frac / d pos = 1), summed over the
//     grid's other axis and over C: one block per box, per-thread partial
//     sums in registers, then warp shuffles and one pass through shared
//     memory. The wrapper's autograd carries them through the clamp into
//     the boxes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void tap(float p, int size, int* i0, int* i1,
                                    float* frac) {
  const float p0 = floorf(p);
  *frac = p - p0;
  const int lo = min(max(static_cast<int>(p0), 0), size - 1);
  *i0 = lo;
  *i1 = min(max(lo + 1, 0), size - 1);
}

// An image's cropped extent clamped to the map's side n. The wrapper does
// not check extents on the card (a host read would stall the forward, and
// a device assert would end the process's CUDA context), so an empty or
// oversized one must not index outside the map. A valid extent is kept.
__device__ __forceinline__ int extent(int e, int n) {
  return min(max(e, 1), n);
}

// a (1 - w) + b w, the lerp of tap(): rows first, then columns
__device__ __forceinline__ float tap_lerp(float a, float b, float w) {
  return a * (1.0f - w) + b * w;
}

__device__ __forceinline__ float4 tap_lerp(float4 a, float4 b, float w) {
  return make_float4(tap_lerp(a.x, b.x, w), tap_lerp(a.y, b.y, w),
                     tap_lerp(a.z, b.z, w), tap_lerp(a.w, b.w, w));
}

// An L2 policy that keeps the lines it loads (evict_last).
__device__ __forceinline__ unsigned long long l2_keep_policy() {
  unsigned long long pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ float load_keep(const float* p,
                                           unsigned long long pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float4 load_keep(const float4* p,
                                            unsigned long long pol) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

// One block per (box r, output row p); V = float4 (a thread owns 4
// channels) or float. feats / out are in units of V, cv = C / (V's width).
template <typename V>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const V* __restrict__ feats, const float* __restrict__ yf,
                     const float* __restrict__ xf,
                     const int* __restrict__ img_idx,
                     const int* __restrict__ feat_h,
                     const int* __restrict__ feat_w, int hf, int wf, int cv,
                     int out_h, int out_w, V* __restrict__ out) {
  const int r = blockIdx.x / out_h;
  const int p = blockIdx.x - r * out_h;
  const unsigned long long pol = l2_keep_policy();
  const V* fb = feats + (size_t)img_idx[r] * hf * wf * cv;
  const int sw = extent(feat_w[r], wf);
  int y0, y1;
  float fy;
  tap(yf[r * out_h + p], extent(feat_h[r], hf), &y0, &y1, &fy);
  const V* row0 = fb + (size_t)y0 * wf * cv;
  const V* row1 = fb + (size_t)y1 * wf * cv;
  const float* xs = xf + (size_t)r * out_w;
  V* o = out + (size_t)blockIdx.x * out_w * cv;
  for (int u = threadIdx.x; u < cv; u += blockDim.x) {
    // v(x) of the previous sample's two columns; x = -1: none yet
    int px0 = -1, px1 = -1;
    V pv0 = V(), pv1 = V();
    for (int q = 0; q < out_w; ++q) {
      int x0, x1;
      float fx;
      tap(xs[q], sw, &x0, &x1, &fx);
      V v0, v1;
      if (x0 == px0) {
        v0 = pv0;
      } else if (x0 == px1) {
        v0 = pv1;
      } else {
        const size_t at = (size_t)x0 * cv + u;
        v0 = tap_lerp(load_keep(row0 + at, pol), load_keep(row1 + at, pol),
                      fy);
      }
      if (x1 == x0) {
        v1 = v0;
      } else if (x1 == px1) {
        v1 = pv1;
      } else if (x1 == px0) {
        v1 = pv0;
      } else {
        const size_t at = (size_t)x1 * cv + u;
        v1 = tap_lerp(load_keep(row0 + at, pol), load_keep(row1 + at, pol),
                      fy);
      }
      __stcs(o + (size_t)q * cv + u, tap_lerp(v0, v1, fx));
      px0 = x0;
      px1 = x1;
      pv0 = v0;
      pv1 = v1;
    }
  }
}

// One block per box; threads over channels. g: (rois, out_h, out_w, c).
__global__ void roi_align_bwd_feats_kernel(const float* __restrict__ g,
                                           const float* __restrict__ yf,
                                           const float* __restrict__ xf,
                                           const int* __restrict__ img_idx,
                                           const int* __restrict__ feat_h,
                                           const int* __restrict__ feat_w,
                                           int hf, int wf, int c, int out_h,
                                           int out_w, float* __restrict__ df) {
  const int r = blockIdx.x;
  float* db = df + (size_t)img_idx[r] * hf * wf * c;
  const int sh = extent(feat_h[r], hf);
  const int sw = extent(feat_w[r], wf);
  const float* gr = g + (size_t)r * out_h * out_w * c;
  for (int p = 0; p < out_h; ++p) {
    int y0, y1;
    float fy;
    tap(yf[r * out_h + p], sh, &y0, &y1, &fy);
    for (int q = 0; q < out_w; ++q) {
      int x0, x1;
      float fx;
      tap(xf[r * out_w + q], sw, &x0, &x1, &fx);
      const float w00 = (1.0f - fx) * (1.0f - fy);
      const float w10 = (1.0f - fx) * fy;
      const float w01 = fx * (1.0f - fy);
      const float w11 = fx * fy;
      float* d00 = db + ((size_t)y0 * wf + x0) * c;
      float* d01 = db + ((size_t)y0 * wf + x1) * c;
      float* d10 = db + ((size_t)y1 * wf + x0) * c;
      float* d11 = db + ((size_t)y1 * wf + x1) * c;
      const float* gs = gr + ((size_t)p * out_w + q) * c;
      for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
        const float gv = gs[ch];
        atomicAdd(d00 + ch, gv * w00);
        atomicAdd(d10 + ch, gv * w10);
        atomicAdd(d01 + ch, gv * w01);
        atomicAdd(d11 + ch, gv * w11);
      }
    }
  }
}

// Largest grid side the coordinate backward keeps in registers.
constexpr int kMaxOut = 16;

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // red is reused between calls
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
  return s;
}

__global__ void roi_align_bwd_coords_kernel(
    const float* __restrict__ g, const float* __restrict__ feats,
    const float* __restrict__ yf, const float* __restrict__ xf,
    const int* __restrict__ img_idx, const int* __restrict__ feat_h,
    const int* __restrict__ feat_w, int hf, int wf, int c, int out_h,
    int out_w, float* __restrict__ dyf, float* __restrict__ dxf) {
  __shared__ float red[kThreads / 32];
  const int r = blockIdx.x;
  const float* fb = feats + (size_t)img_idx[r] * hf * wf * c;
  const int sh = extent(feat_h[r], hf);
  const int sw = extent(feat_w[r], wf);
  const float* gr = g + (size_t)r * out_h * out_w * c;
  float ay[kMaxOut], ax[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) ay[i] = ax[i] = 0.0f;
#pragma unroll
  for (int p = 0; p < kMaxOut; ++p) {
    if (p >= out_h) break;
    int y0, y1;
    float fy;
    tap(yf[r * out_h + p], sh, &y0, &y1, &fy);
#pragma unroll
    for (int q = 0; q < kMaxOut; ++q) {
      if (q >= out_w) break;
      int x0, x1;
      float fx;
      tap(xf[r * out_w + q], sw, &x0, &x1, &fx);
      const float* f00 = fb + ((size_t)y0 * wf + x0) * c;
      const float* f01 = fb + ((size_t)y0 * wf + x1) * c;
      const float* f10 = fb + ((size_t)y1 * wf + x0) * c;
      const float* f11 = fb + ((size_t)y1 * wf + x1) * c;
      const float* gs = gr + ((size_t)p * out_w + q) * c;
      float sy = 0.0f, sx = 0.0f;
      for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
        const float gv = gs[ch];
        const float a = f00[ch], b = f01[ch], d = f10[ch], e = f11[ch];
        sy += gv * ((1.0f - fx) * (d - a) + fx * (e - b));
        sx += gv * ((1.0f - fy) * (b - a) + fy * (e - d));
      }
      ay[p] += sy;
      ax[q] += sx;
    }
  }
#pragma unroll
  for (int p = 0; p < kMaxOut; ++p) {
    if (p >= out_h) break;
    const float s = block_sum(ay[p], red);
    if (threadIdx.x == 0) dyf[r * out_h + p] = s;
  }
#pragma unroll
  for (int q = 0; q < kMaxOut; ++q) {
    if (q >= out_w) break;
    const float s = block_sum(ax[q], red);
    if (threadIdx.x == 0) dxf[r * out_w + q] = s;
  }
}

}  // namespace

// feats: (images, hf, wf, c) f32 contiguous. yf: (rois, out_h), xf:
// (rois, out_w) f32 sample positions. img_idx / feat_h / feat_w: (rois,)
// int32, each box's image and that image's cropped feature extent (1..hf,
// 1..wf; the kernels clamp one outside).
// out: (rois, out_h, out_w, c) f32. Any c; 16-byte accesses when c % 4
// == 0 and feats and out are 16-byte aligned.
extern "C" int dc_roi_align_fwd(const void* feats, const void* yf,
                                const void* xf, const void* img_idx,
                                const void* feat_h, const void* feat_w,
                                int rois, int hf, int wf, int c, int out_h,
                                int out_w, void* out, void* stream) {
  if (rois == 0 || out_h == 0 || out_w == 0 || c == 0) return 0;
  const bool vec = c % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int cv = vec ? c / 4 : c;
  // whole warps, at most kThreads; a thread loops when cv is larger
  const int threads = cv < kThreads ? (cv + 31) / 32 * 32 : kThreads;
  const unsigned blocks = (unsigned)rois * (unsigned)out_h;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* y = static_cast<const float*>(yf);
  const float* x = static_cast<const float*>(xf);
  const int* ii = static_cast<const int*>(img_idx);
  const int* fh = static_cast<const int*>(feat_h);
  const int* fw = static_cast<const int*>(feat_w);
  if (vec) {
    roi_align_fwd_kernel<float4><<<blocks, threads, 0, s>>>(
        static_cast<const float4*>(feats), y, x, ii, fh, fw, hf, wf, cv,
        out_h, out_w, static_cast<float4*>(out));
  } else {
    roi_align_fwd_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(feats), y, x, ii, fh, fw, hf, wf, cv,
        out_h, out_w, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// g: (rois, out_h, out_w, c) f32 upstream gradient; the other arguments
// as for dc_roi_align_fwd. df: (images, hf, wf, c) f32, zeroed by the
// caller; the kernel adds into it.
extern "C" int dc_roi_align_bwd_feats(const void* g, const void* yf,
                                      const void* xf, const void* img_idx,
                                      const void* feat_h, const void* feat_w,
                                      int rois, int hf, int wf, int c,
                                      int out_h, int out_w, void* df,
                                      void* stream) {
  if (rois == 0) return 0;
  roi_align_bwd_feats_kernel<<<rois, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(yf),
      static_cast<const float*>(xf), static_cast<const int*>(img_idx),
      static_cast<const int*>(feat_h), static_cast<const int*>(feat_w), hf,
      wf, c, out_h, out_w, static_cast<float*>(df));
  return static_cast<int>(cudaGetLastError());
}

// dyf: (rois, out_h), dxf: (rois, out_w) f32, written (not added).
// out_h and out_w must be <= 16.
extern "C" int dc_roi_align_bwd_coords(const void* g, const void* feats,
                                       const void* yf, const void* xf,
                                       const void* img_idx,
                                       const void* feat_h, const void* feat_w,
                                       int rois, int hf, int wf, int c,
                                       int out_h, int out_w, void* dyf,
                                       void* dxf, void* stream) {
  if (rois == 0) return 0;
  if (out_h > kMaxOut || out_w > kMaxOut) return -1;
  roi_align_bwd_coords_kernel<<<rois, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(feats),
      static_cast<const float*>(yf), static_cast<const float*>(xf),
      static_cast<const int*>(img_idx), static_cast<const int*>(feat_h),
      static_cast<const int*>(feat_w), hf, wf, c, out_h, out_w,
      static_cast<float*>(dyf), static_cast<float*>(dxf));
  return static_cast<int>(cudaGetLastError());
}
