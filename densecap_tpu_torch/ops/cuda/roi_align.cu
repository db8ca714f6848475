// K2: RoI align forward, a direct 4-tap bilinear gather over
// channels-last features.
//
// Replaces densecap_tpu/ops/pallas/roi_align_kernel.py:roi_align_pallas
// (_kernel). The TPU kernel builds dense tent-weight matrices and runs two
// MXU contractions so that the gather becomes matrix work; on Hopper the
// gather itself is cheap, so each output sample reads its four
// neighbouring feature rows directly.
//
// Layout: one block per box, threads over the C channels. A feature row
// (one pixel, all C channels) is contiguous in NHWC, so each tap is a
// coalesced read, and each output sample writes C contiguous floats.
//
// What bounds it on the H100: the output. At the flagship shape (8 images
// x 1000 boxes x 7 x 7 x 512 f32) it writes 803 MB, while the feature maps
// it reads (8 x 45 x 45 x 512 f32 = 33 MB) stay in the 50 MB L2. The kernel
// is therefore bound by device-memory write bandwidth; it does no work
// beyond the four loads, two lerps per row pair and one store per output.
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

__global__ void roi_align_fwd_kernel(const float* __restrict__ feats,
                                     const float* __restrict__ yf,
                                     const float* __restrict__ xf,
                                     const int* __restrict__ img_idx,
                                     const int* __restrict__ feat_h,
                                     const int* __restrict__ feat_w,
                                     int hf, int wf, int c, int out_h,
                                     int out_w, float* __restrict__ out) {
  const int r = blockIdx.x;
  const float* fb = feats + (size_t)img_idx[r] * hf * wf * c;
  const int sh = feat_h[r];
  const int sw = feat_w[r];
  float* o = out + (size_t)r * out_h * out_w * c;
  for (int p = 0; p < out_h; ++p) {
    int y0, y1;
    float fy;
    tap(yf[r * out_h + p], sh, &y0, &y1, &fy);
    for (int q = 0; q < out_w; ++q) {
      int x0, x1;
      float fx;
      tap(xf[r * out_w + q], sw, &x0, &x1, &fx);
      const float* f00 = fb + ((size_t)y0 * wf + x0) * c;
      const float* f01 = fb + ((size_t)y0 * wf + x1) * c;
      const float* f10 = fb + ((size_t)y1 * wf + x0) * c;
      const float* f11 = fb + ((size_t)y1 * wf + x1) * c;
      float* os = o + ((size_t)p * out_w + q) * c;
      for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
        const float r0 = f00[ch] * (1.0f - fy) + f10[ch] * fy;
        const float r1 = f01[ch] * (1.0f - fy) + f11[ch] * fy;
        os[ch] = r0 * (1.0f - fx) + r1 * fx;
      }
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
  const int sh = feat_h[r];
  const int sw = feat_w[r];
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
  const int sh = feat_h[r];
  const int sw = feat_w[r];
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
// int32, each box's image and that image's cropped feature extent (>= 1).
// out: (rois, out_h, out_w, c) f32.
extern "C" int dc_roi_align_fwd(const void* feats, const void* yf,
                                const void* xf, const void* img_idx,
                                const void* feat_h, const void* feat_w,
                                int rois, int hf, int wf, int c, int out_h,
                                int out_w, void* out, void* stream) {
  if (rois == 0) return 0;
  roi_align_fwd_kernel<<<rois, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const float*>(yf),
      static_cast<const float*>(xf), static_cast<const int*>(img_idx),
      static_cast<const int*>(feat_h), static_cast<const int*>(feat_w), hf,
      wf, c, out_h, out_w, static_cast<float*>(out));
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
