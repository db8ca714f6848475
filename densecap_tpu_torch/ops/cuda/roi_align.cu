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
// K2b, the backward (dc_roi_align_bwd), replaces the JAX package's
// autodiff of the gather (densecap_tpu/ops/roi_align.py:roi_align; the TPU
// kernel has no backward). It computes, in one pass over the upstream
// gradient g:
//   * the gradient of the sample positions,
//     d out / d yf = (1-fx)(f[y1,x0]-f[y0,x0]) + fx(f[y1,x1]-f[y0,x1])
//     and d out / d xf = v(x1) - v(x0) (floor has zero gradient, so
//     d frac / d pos = 1), summed over the grid's other axis and over C;
//     the wrapper's autograd carries them through the clamp into the boxes;
//   * with the trunk trainable (the kFeats instance), the feature
//     gradient: the scatter-add of the four taps with weights
//     (1-fy)(1-fx), fy(1-fx), (1-fy)fx, fy fx. A clamped tap with
//     i0 == i1 adds twice into one cell, as autodiff does.
// What bounds it on the H100: reading g, (3072, 7, 7, 512) f32 = 308 MB at
// the training shape, against a 33 MB map (and a 33 MB d feats) that stay
// in L2: 0.10 ms at 3.35 TB/s (0.11 with d feats). The design:
//   * K2's grid, one block per (box, output row), a thread on 4 channels
//     with 16-byte loads; g streams in with evict-first loads, one sample
//     ahead, and the taps load under the map's evict_last policy, each
//     column's lerp and difference reused by both samples that tap it;
//   * one reduction per block, not one per sample and axis: each warp
//     sums a sample's d xf with shuffles into a slot in shared memory, and
//     after the row one pass sums the warps in a fixed order. A box's rows
//     are other blocks, so each block writes its row's share of d xf and
//     the wrapper sums the (R, out_h, out_w) shares over out_h: no barrier
//     across blocks. A cluster per box with a distributed-shared-memory
//     sum, and a last-block-per-box sum behind a fence, both measured
//     slower on the card (the barriers hold the blocks; the fence waits
//     for the block's reductions into d feats). Both position gradients
//     are the same in every run;
//   * register limits that keep 8 blocks (6 with d feats) on an SM, so
//     enough loads of g are in flight;
//   * d feats: consecutive samples of a row that tap the same column add
//     their weighted g in registers; a column leaves as one 16-byte vector
//     reduction per feature row (sm_90's float4 atomicAdd), not four
//     scalar atomics per sample. Overlapping boxes add into the same cells
//     in an order that changes from run to run.

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

// Largest grid side K2b takes: a warp keeps one partial per output
// column in shared memory.
constexpr int kMaxOut = 16;

// The upstream gradient is read once: streaming loads (evict-first in L1
// and L2), so it does not push the feature map out of L2.
__device__ __forceinline__ float load_once(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float4 load_once(const float4* p) {
  return __ldcs(p);
}

__device__ __forceinline__ float dot(float a, float b) { return a * b; }
__device__ __forceinline__ float dot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ float4 sub(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ float scale(float a, float w) { return a * w; }
__device__ __forceinline__ float4 scale(float4 a, float w) {
  return make_float4(a.x * w, a.y * w, a.z * w, a.w * w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One reduction into global memory per V: a vector atomic on sm_90 (the
// result is unused, so it compiles to a reduction, RED, not ATOM).
__device__ __forceinline__ void red_add(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void red_add(float4* p, float4 v) {
  atomicAdd(p, v);
}

// The taps' accumulated weights for feature column x of the block's two
// feature rows: acc (1 - fy) into row y0, acc fy into row y1.
template <typename V>
__device__ __forceinline__ void add_column(V* drow0, V* drow1, int x, int cv,
                                           int u, V acc, float fy) {
  red_add(drow0 + (size_t)x * cv + u, scale(acc, 1.0f - fy));
  red_add(drow1 + (size_t)x * cv + u, scale(acc, fy));
}

// K2b: one block per (box r, output row p); V = float4 (a thread owns 4
// channels) or float. kFeats: also scatter d feats (the trunk trains). g /
// feats / df are in units of V, cv = C / (V's width). Writes d yf[r, p] and
// this row's share of d xf, dxf_rows[r, p, :]. Register limits from the
// card (NVIDIA H100, scripts/torch_k2b_alone.py): 8 blocks per SM for the
// positions alone with the sample loop unrolled, 6 with d feats and the
// loop rolled (the d feats accumulators spill otherwise).
template <typename V, bool kFeats>
__global__ void __launch_bounds__(kThreads, kFeats ? 6 : 8)
roi_align_bwd_kernel(const V* __restrict__ g, const V* __restrict__ feats,
                     const float* __restrict__ yf,
                     const float* __restrict__ xf,
                     const int* __restrict__ img_idx,
                     const int* __restrict__ feat_h,
                     const int* __restrict__ feat_w, int hf, int wf, int cv,
                     int out_h, int out_w, float* __restrict__ dyf,
                     float* __restrict__ dxf_rows, V* __restrict__ df) {
  // per warp: its sum of d yf (slot 0) and of each column's d xf (1..)
  __shared__ float red[kThreads / 32][kMaxOut + 1];
  const int r = blockIdx.x / out_h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned long long pol = l2_keep_policy();
  const size_t img_base = (size_t)img_idx[r] * hf * wf * cv;
  const int sw = extent(feat_w[r], wf);
  int y0, y1;
  float fy;
  tap(yf[blockIdx.x], extent(feat_h[r], hf), &y0, &y1, &fy);
  const V* row0 = feats + img_base + (size_t)y0 * wf * cv;
  const V* row1 = feats + img_base + (size_t)y1 * wf * cv;
  V* drow0 = kFeats ? df + img_base + (size_t)y0 * wf * cv : nullptr;
  V* drow1 = kFeats ? df + img_base + (size_t)y1 * wf * cv : nullptr;
  const float* xs = xf + (size_t)r * out_w;
  const V* gr = g + (size_t)blockIdx.x * out_w * cv;
  if (lane == 0)
    for (int j = 0; j <= out_w; ++j) red[warp][j] = 0.0f;
  __syncwarp();
  float ay = 0.0f;  // this thread's share of d yf[r, p]
  // every thread runs every step (the warp sums need all lanes); a lane
  // past the channels loads and adds nothing
  for (int u0 = 0; u0 < cv; u0 += blockDim.x) {
    const int u = u0 + threadIdx.x;
    const bool on = u < cv;
    // the previous sample's two columns: v(x) = f[y0,x](1-fy) + f[y1,x]fy
    // and d(x) = f[y1,x] - f[y0,x]; x = -1: none yet
    int px0 = -1, px1 = -1;
    V pv0 = V(), pd0 = V(), pv1 = V(), pd1 = V();
    // d feats: the summed column weights of the consecutive samples that
    // tap columns ac0 / ac1, not yet added into df; -1: none
    int ac0 = -1, ac1 = -1;
    V acc0 = V(), acc1 = V();
    V gnext = on ? load_once(gr + u) : V();
#pragma unroll(kFeats ? 1 : kMaxOut)
    for (int q = 0; q < kMaxOut; ++q) {
      if (q >= out_w) break;
      const V gv = gnext;
      if (on && q + 1 < out_w) gnext = load_once(gr + (size_t)(q + 1) * cv + u);
      int x0, x1;
      float fx;
      tap(xs[q], sw, &x0, &x1, &fx);
      V v0, d0, v1, d1;
      if (x0 == px0) {
        v0 = pv0, d0 = pd0;
      } else if (x0 == px1) {
        v0 = pv1, d0 = pd1;
      } else {
        const size_t at = (size_t)x0 * cv + u;
        const V a = on ? load_keep(row0 + at, pol) : V();
        const V b = on ? load_keep(row1 + at, pol) : V();
        v0 = tap_lerp(a, b, fy), d0 = sub(b, a);
      }
      if (x1 == x0) {
        v1 = v0, d1 = d0;
      } else if (x1 == px1) {
        v1 = pv1, d1 = pd1;
      } else if (x1 == px0) {
        v1 = pv0, d1 = pd0;
      } else {
        const size_t at = (size_t)x1 * cv + u;
        const V a = on ? load_keep(row0 + at, pol) : V();
        const V b = on ? load_keep(row1 + at, pol) : V();
        v1 = tap_lerp(a, b, fy), d1 = sub(b, a);
      }
      // out = v(x0)(1-fx) + v(x1)fx: d out / d yf and d out / d xf
      ay += (1.0f - fx) * dot(gv, d0) + fx * dot(gv, d1);
      const float sx = warp_sum(dot(gv, sub(v1, v0)));
      if (lane == 0) red[warp][q + 1] += sx;
      px0 = x0, px1 = x1;
      pv0 = v0, pd0 = d0, pv1 = v1, pd1 = d1;
      if (kFeats && on) {
        // add out the columns this sample does not tap (the same for
        // every thread of the block), then merge its weights in
        if (ac0 >= 0 && ac0 != x0 && ac0 != x1)
          add_column(drow0, drow1, ac0, cv, u, acc0, fy);
        if (ac1 >= 0 && ac1 != x0 && ac1 != x1)
          add_column(drow0, drow1, ac1, cv, u, acc1, fy);
        const V w0 = scale(gv, 1.0f - fx), w1 = scale(gv, fx);
        const V n0 = x0 == ac0   ? add(acc0, w0)
                     : x0 == ac1 ? add(acc1, w0)
                                 : w0;
        if (x1 == x0) {
          acc0 = add(n0, w1), ac0 = x0, ac1 = -1;
        } else {
          acc1 = x1 == ac0 ? add(acc0, w1) : x1 == ac1 ? add(acc1, w1) : w1;
          acc0 = n0, ac0 = x0, ac1 = x1;
        }
      }
    }
    if (kFeats && on) {
      // a clamped row (y0 == y1) takes both adds into one cell, as
      // autodiff does
      add_column(drow0, drow1, ac0, cv, u, acc0, fy);
      if (ac1 >= 0) add_column(drow0, drow1, ac1, cv, u, acc1, fy);
    }
  }
  ay = warp_sum(ay);
  if (lane == 0) red[warp][0] = ay;
  __syncthreads();
  // the warps' partials summed in a fixed order: d yf[r, p], and this
  // row's d xf, which the wrapper sums over the box's rows in a fixed
  // order too, so both position gradients are the same in every run
  if (threadIdx.x <= out_w) {
    float s = 0.0f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w][threadIdx.x];
    if (threadIdx.x == 0) {
      dyf[blockIdx.x] = s;
    } else {
      dxf_rows[(size_t)blockIdx.x * out_w + threadIdx.x - 1] = s;
    }
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

// K2b, one launch. g: (rois, out_h, out_w, c) f32 upstream gradient; the
// other inputs as for dc_roi_align_fwd. dyf: (rois, out_h) f32 and
// dxf_rows: (rois, out_h, out_w) f32, each row's share of d xf (the caller
// sums over out_h), both written (not added). df: (images, hf, wf, c)
// f32, zeroed by the caller, which the kernel adds into; NULL for the
// positions alone (the trunk is frozen). out_w must be <= 16. 16-byte
// accesses when c % 4 == 0 and g, feats and df are 16-byte aligned.
extern "C" int dc_roi_align_bwd(const void* g, const void* feats,
                                const void* yf, const void* xf,
                                const void* img_idx, const void* feat_h,
                                const void* feat_w, int rois, int hf, int wf,
                                int c, int out_h, int out_w, void* dyf,
                                void* dxf_rows, void* df, void* stream) {
  if (rois == 0 || out_h == 0 || out_w == 0) return 0;
  if (out_w > kMaxOut) return -1;
  const auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  const bool vec = c % 4 == 0 && aligned(g) && aligned(feats) &&
                   (df == nullptr || aligned(df));
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
  float* dy = static_cast<float*>(dyf);
  float* dx = static_cast<float*>(dxf_rows);
  if (vec && df) {
    roi_align_bwd_kernel<float4, true><<<blocks, threads, 0, s>>>(
        static_cast<const float4*>(g), static_cast<const float4*>(feats), y,
        x, ii, fh, fw, hf, wf, cv, out_h, out_w, dy, dx,
        static_cast<float4*>(df));
  } else if (vec) {
    roi_align_bwd_kernel<float4, false><<<blocks, threads, 0, s>>>(
        static_cast<const float4*>(g), static_cast<const float4*>(feats), y,
        x, ii, fh, fw, hf, wf, cv, out_h, out_w, dy, dx, nullptr);
  } else if (df) {
    roi_align_bwd_kernel<float, true><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(feats), y, x,
        ii, fh, fw, hf, wf, cv, out_h, out_w, dy, dx,
        static_cast<float*>(df));
  } else {
    roi_align_bwd_kernel<float, false><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(feats), y, x,
        ii, fh, fw, hf, wf, cv, out_h, out_w, dy, dx, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
