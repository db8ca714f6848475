// K1: exact greedy NMS over score-sorted boxes, all images in one launch.
//
// Replaces densecap_tpu/ops/pallas/nms_kernel.py:nms_pallas (_make_kernel).
// The Pallas kernel walks 128-box tiles in order on one TPU core and
// carries the `alive` mask across its sequential grid. Hopper has no such
// order between blocks, so the work is split in two launches:
//
//   1. nms_mask_kernel, grid (column block, row block, image), 64 threads:
//      thread i of a row block writes one 64-bit word per column block,
//      bit k set when later box j = col*64 + k overlaps box i by IoU >
//      thresh. This is O(N^2) IoU work, fully parallel over the card.
//   2. nms_scan_kernel, one block per image: walks the boxes in score
//      order with a `removed` bitset and a `valid` bitset in shared
//      memory, keeps a box when it is valid and not removed, ORs its mask
//      row into `removed` and stops at max_out kept boxes.
//
// What bounds it on the H100: at the RPN shape (8 x 6000 boxes) the mask
// is 8 x 6000 x 94 words = 36 MB written once and read only along kept
// rows, so launch 1 is bound by IoU arithmetic spread over every SM, and
// launch 2 by its serial dependency chain (one kept box after another, two
// block barriers each) on 8 SMs. The scan jumps straight to the next
// candidate bit of a word (__ffsll), so its serial steps are the kept
// boxes, not all N.
//
// Exactness: the picks must equal the plain PyTorch sweep bit for bit, so
// the IoU is computed in the same f32 operation order as iou_pascal,
// inter / (area_i + area_j - inter), with IEEE division. The library is
// built with -fmad=false and without --use_fast_math, so no multiply-add
// is contracted into an FMA that could flip a pair on the threshold.
// Sorting stays outside, in the PyTorch wrapper, as nms_pallas sorts
// outside its pallas_call.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockBoxes = 64;
constexpr int kScanThreads = 128;

__device__ __forceinline__ float box_area(const float4 b) {
  return (b.z - b.x + 1.0f) * (b.w - b.y + 1.0f);
}

__device__ __forceinline__ bool overlaps(const float4 a, const float4 b,
                                         float thresh) {
  const float xx1 = fmaxf(a.x, b.x);
  const float yy1 = fmaxf(a.y, b.y);
  const float xx2 = fminf(a.z, b.z);
  const float yy2 = fminf(a.w, b.w);
  const float iw = fmaxf(xx2 - xx1 + 1.0f, 0.0f);
  const float ih = fmaxf(yy2 - yy1 + 1.0f, 0.0f);
  const float inter = iw * ih;
  const float uni = box_area(a) + box_area(b) - inter;
  return inter / uni > thresh;
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n,
                                int col_blocks, float thresh,
                                unsigned long long* __restrict__ mask) {
  const int col = blockIdx.x;
  const int row = blockIdx.y;
  if (col < row) return;  // only later boxes can be suppressed
  const int img = blockIdx.z;
  const float4* bx = boxes + (size_t)img * n;
  const int row_size = min(n - row * kBlockBoxes, kBlockBoxes);
  const int col_size = min(n - col * kBlockBoxes, kBlockBoxes);

  __shared__ float4 cols[kBlockBoxes];
  if (threadIdx.x < col_size) {
    cols[threadIdx.x] = bx[col * kBlockBoxes + threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x >= row_size) return;

  const int i = row * kBlockBoxes + threadIdx.x;
  const float4 cur = bx[i];
  unsigned long long bits = 0ULL;
  const int start = (row == col) ? threadIdx.x + 1 : 0;
  for (int k = start; k < col_size; ++k) {
    if (overlaps(cur, cols[k], thresh)) bits |= 1ULL << k;
  }
  mask[((size_t)img * n + i) * col_blocks + col] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid, int n,
                                int col_blocks, int max_out,
                                int* __restrict__ keep,
                                int* __restrict__ count) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;
  unsigned long long* vbits = smem + col_blocks;
  const int img = blockIdx.x;
  const uint8_t* v = valid + (size_t)img * n;
  const unsigned long long* m = mask + (size_t)img * n * col_blocks;
  int* kb = keep + (size_t)img * max_out;

  for (int w = threadIdx.x; w < col_blocks; w += blockDim.x) {
    unsigned long long bits = 0ULL;
    const int lim = min(n - w * kBlockBoxes, kBlockBoxes);
    for (int k = 0; k < lim; ++k) {
      if (v[w * kBlockBoxes + k]) bits |= 1ULL << k;
    }
    vbits[w] = bits;
    removed[w] = 0ULL;
  }
  __syncthreads();

  // Every thread reads the same shared words after a barrier, so `cand`
  // and every branch below are uniform across the block.
  int kept = 0;
  for (int w = 0; w < col_blocks && kept < max_out; ++w) {
    unsigned long long cand = vbits[w] & ~removed[w];
    while (cand != 0ULL && kept < max_out) {
      const int bit = __ffsll((long long)cand) - 1;
      const int i = w * kBlockBoxes + bit;
      if (threadIdx.x == 0) kb[kept] = i;
      ++kept;
      __syncthreads();  // all reads of removed[w] precede the ORs below
      const unsigned long long* row = m + (size_t)i * col_blocks;
      for (int x = w + threadIdx.x; x < col_blocks; x += blockDim.x) {
        removed[x] |= row[x];
      }
      __syncthreads();
      const unsigned long long later =
          bit == 63 ? 0ULL : (~0ULL << (bit + 1));
      cand = vbits[w] & ~removed[w] & later;
    }
  }
  for (int s = kept + threadIdx.x; s < max_out; s += blockDim.x) kb[s] = 0;
  if (threadIdx.x == 0) count[img] = kept;
}

}  // namespace

// boxes: (batch, n, 4) f32 x1y1x2y2, sorted by score, 16-byte aligned.
// valid: (batch, n) uint8. mask: (batch, n, ceil(n/64)) uint64 scratch.
// keep: (batch, max_out) int32 sorted positions (0 past the count).
// count: (batch,) int32 number of kept boxes.
extern "C" int dc_nms(const void* boxes, const void* valid, int batch, int n,
                      int max_out, float thresh, void* mask, void* keep,
                      void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int col_blocks = (n + kBlockBoxes - 1) / kBlockBoxes;
  const dim3 grid(col_blocks, col_blocks, batch);
  nms_mask_kernel<<<grid, kBlockBoxes, 0, s>>>(
      static_cast<const float4*>(boxes), n, col_blocks, thresh,
      static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = 2 * (size_t)col_blocks * sizeof(unsigned long long);
  nms_scan_kernel<<<batch, kScanThreads, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), n, col_blocks, max_out,
      static_cast<int*>(keep), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
