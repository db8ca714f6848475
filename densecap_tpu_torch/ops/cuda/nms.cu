// K1: exact greedy NMS over score-sorted boxes, one launch per call, one
// thread-block cluster of 8 blocks per image.
//
// Replaces densecap_tpu/ops/pallas/nms_kernel.py:nms_pallas (_make_kernel).
// The Pallas kernel walks 128-box tiles in score order on one TPU core,
// settles each tile by a greedy fixpoint and then suppresses every later
// box. Here each image's cluster walks the sorted boxes in 64-box tiles.
// Every block of the cluster keeps the same list of survivors found so far
// (box and area) in its shared memory, and for each tile:
//
//   (a) every valid candidate of the tile is tested against the kept boxes
//       of earlier tiles, 16 lanes per candidate, each lane 4 kept boxes a
//       round (independent tests, so their latencies overlap), OR-reduced
//       with a warp ballot; a warp stops as soon as all of its candidates
//       are suppressed. Once 256 boxes are kept and most candidates
//       survive (the last tile kept at least half of its boxes), block r
//       of the cluster takes only the kept boxes r, r + 8, ...; otherwise
//       every block tests them all;
//   (b) the same 16 lanes build the candidate's 64-bit overlap word against
//       the later boxes of its own tile (skipped once it is suppressed);
//   (c) when (a) was split, each block sends its 64-bit mask of pulled
//       candidates to every block of the cluster (distributed shared
//       memory) before one cluster barrier; warp 0 of each block settles
//       the tile in registers: alive = not pulled anywhere; it walks, with
//       __ffsll and one
//       __shfl_sync each, only the alive boxes whose overlap word is not 0
//       (a box that suppresses nothing in the tile cannot change the
//       outcome), clearing what each one suppresses;
//   (d) warp 0 appends the survivors in order, by popcount ranks, up to
//       max_out (block 0 writes them out), and the walk stops once max_out
//       boxes are kept. Every block computes the same survivors.
//
// So the IoU work is (visited boxes) x (kept boxes), not N^2, spread over
// 8 SMs per image where it is large; no overlap mask goes to device
// memory; and the serial chain is two or three block barriers per tile (a
// cluster barrier on split tiles) plus one shuffle per tile box that
// suppresses a later one, not two barriers and a dependent global read per
// kept box.
//
// What bounds it on the H100: a roofline puts it at a few microseconds
// (at most 8 x 1000 x 6000 IoU tests of ~16 f32 operations at the RPN
// shape; 0.8 MB of boxes). The floor that holds is the chain of tiles:
// visited / 64 steps per image, each step the largest block's share of
// (a) plus (b)-(d) and the barriers.
//
// Exactness: the picks must equal the plain PyTorch sweep bit for bit, so
// each IoU follows iou_pascal's f32 operation order, inter / (area_a +
// area_b - inter), with IEEE division (f32 addition and max / min commute,
// so which box is "a" does not matter). The library is built with
// -fmad=false and without --use_fast_math. `above` may decide a pair
// without the division only where the outcome provably equals
// fl(inter / uni) > t (see its comment). Sorting stays outside, in the
// PyTorch wrapper, as nms_pallas sorts outside its pallas_call.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // boxes per tile: one 64-bit word per box
constexpr int kLanes = 16;        // lanes per tile box in (a) and (b)
constexpr int kUnroll = 4;        // kept boxes a lane tests per round in (a)
constexpr int kThreads = kTile * kLanes;
constexpr int kCluster = 8;       // blocks per image, one thread-block cluster
// (a) is split over the cluster once this many boxes are kept and the last
// tile kept at least half its boxes (see the kernel)
constexpr int kSplitKept = 256;
constexpr unsigned kFull = 0xffffffffu;
// 1 + 2^-20 and 1 - 2^-20, both exact in f32
constexpr float kUp = 1.00000095367431640625f;
constexpr float kDown = 0.99999904632568359375f;
constexpr float kTiny = 0x1p-60f;
constexpr float kHuge = 0x1p60f;

__device__ __forceinline__ float box_area(const float4 b) {
  return (b.z - b.x + 1.0f) * (b.w - b.y + 1.0f);
}

// The pascal +1 intersection and union of a and b, in iou_pascal's order.
__device__ __forceinline__ void overlap(const float4 a, float area_a,
                                        const float4 b, float area_b,
                                        float* inter, float* uni) {
  const float xx1 = fmaxf(a.x, b.x);
  const float yy1 = fmaxf(a.y, b.y);
  const float xx2 = fminf(a.z, b.z);
  const float yy2 = fminf(a.w, b.w);
  const float iw = fmaxf(xx2 - xx1 + 1.0f, 0.0f);
  const float ih = fmaxf(yy2 - yy1 + 1.0f, 0.0f);
  *inter = iw * ih;
  *uni = area_a + area_b - *inter;
}

// fl(inter / uni) > t, the division taken only where it is needed.
//
// zero_skip (host: t >= 0): inter == 0 gives 0 / uni = +-0 or NaN, never
// above t. fast (host: 2^-60 <= t <= 2^60): with uni and inter in
// [2^-60, 2^60] every product below is a normal f32, each rounding is
// within a factor (1 +- 2^-24), so
//   inter > fl(fl(t * uni) * kUp)   implies r = inter / uni > t (1 + 2^-21)
//   inter < fl(fl(t * uni) * kDown) implies r < t (1 - 2^-21).
// The f32 neighbours of t lie within t * 2^-23 of it, so the first r rounds
// to at least the successor of t and the second to at most its
// predecessor: the division would give the same answer. Pairs between the
// two bounds take the division. The common cases have no branch, so the
// tests of several pairs overlap.
__device__ __forceinline__ bool above(float inter, float uni, float t,
                                      bool zero_skip, bool fast) {
  const bool ranged = fast && uni >= kTiny && uni <= kHuge && inter >= kTiny;
  const float p = t * uni;
  const bool yes = ranged && inter > p * kUp;
  const bool no = (zero_skip && inter == 0.0f) || (ranged && inter < p * kDown);
  if (yes || no) return yes;
  return inter / uni > t;
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1)
nms_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
           int n, int max_out, float thresh, int zero_skip_flag,
           int fast_flag, int* __restrict__ keep, int* __restrict__ count) {
  extern __shared__ float4 kept_box[];  // max_out boxes, then their areas
  float* kept_area = reinterpret_cast<float*>(kept_box + max_out);
  __shared__ float4 tile_box[kTile];
  __shared__ float tile_area[kTile];
  __shared__ unsigned long long tile_word[kTile];
  __shared__ int tile_alive[kTile];
  __shared__ unsigned tile_valid[kTile / 32];
  __shared__ int s_kept;
  // the rows each block of the cluster found pulled, in two buffers that
  // split tiles take in turn; other blocks write them (distributed shared
  // memory) only after the cluster barrier before the tile loop, which
  // shows every block of the cluster running
  __shared__ unsigned long long pulled_by[2][kCluster];

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const bool zero_skip = zero_skip_flag != 0;
  const bool fast = fast_flag != 0;
  const int img = blockIdx.x / kCluster;
  const float4* bx = boxes + (size_t)img * n;
  const uint8_t* vb = valid + (size_t)img * n;
  int* kb = keep + (size_t)img * max_out;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid / kLanes;  // the tile box this lane works for
  const int sub = tid % kLanes;
  const unsigned group = ((1u << kLanes) - 1u) << (lane & ~(kLanes - 1));

  // the last two warps hold the next tile's boxes and valid bytes in
  // registers: the loads are in flight while the block works on the
  // current tile, and warp 0, which settles each tile, never waits on them
  const int pf = tid - (kThreads - kTile);
  float4 nb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  uint8_t nv = 0;
  if (pf >= 0 && pf < n) {
    nb = bx[pf];
    nv = vb[pf];
  }

  int kept = 0;  // uniform over the cluster: every thread reads s_kept
  int last = 0;  // boxes the last tile kept, uniform too
  int parity = 0;  // pulled_by buffer of the next split tile
  cluster.sync();  // before any block maps another's shared memory
  for (int start = 0; start < n && kept < max_out; start += kTile) {
    // Splitting (a) costs a cluster barrier and the early exit of the
    // blocks that do not hold a candidate's suppressor; it pays when many
    // kept boxes each get tested in full, i.e. when most candidates
    // survive. Otherwise every block runs all of (a) itself.
    const bool split = kept >= kSplitKept && 2 * last >= kTile;
    const int first = split ? rank : 0;
    const int stride = split ? kCluster : 1;
    if (pf >= 0) {  // two whole warps
      tile_box[pf] = nb;
      tile_area[pf] = box_area(nb);
      const unsigned vbits = __ballot_sync(kFull, nv != 0);
      if (lane == 0) tile_valid[pf >> 5] = vbits;
      const int j = start + kTile + pf;
      nv = 0;
      if (j < n) {
        nb = bx[j];
        nv = vb[j];
      }
    }
    __syncthreads();

    const float4 cb = tile_box[row];
    const float ca = tile_area[row];
    // (a) pulled: invalid, or suppressed by a kept box of an earlier tile.
    // This block tests the kept boxes first, first + stride, ...: mine of
    // them. A lane tests kUnroll of those a round, kLanes apart.
    bool pulled = !((tile_valid[row >> 5] >> (row & 31)) & 1u);
    const int mine = (kept - first + stride - 1) / stride;
    for (int m0 = 0; m0 < mine; m0 += kLanes * kUnroll) {
      bool hit = false;
      if (!pulled) {
        float inter[kUnroll], uni[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = first + min(m0 + u * kLanes + sub, mine - 1) * stride;
          overlap(kept_box[k], kept_area[k], cb, ca, &inter[u], &uni[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          hit = hit || (m0 + u * kLanes + sub < mine &&
                        above(inter[u], uni[u], thresh, zero_skip, fast));
        }
      }
      // every lane must reach the vote: no short circuit around it
      const unsigned votes = __ballot_sync(kFull, hit);
      pulled = pulled || (votes & group) != 0u;
      if (__all_sync(kFull, pulled)) break;
    }
    // (b) bit j: later tile box j overlaps this one above the threshold
    unsigned long long word = 0ULL;
    if (!pulled) {
      constexpr int kCols = kTile / kLanes;
      float inter[kCols], uni[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = sub * kCols + c;
        overlap(cb, ca, tile_box[j], tile_area[j], &inter[c], &uni[c]);
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = sub * kCols + c;
        if (j > row && above(inter[c], uni[c], thresh, zero_skip, fast)) {
          word |= 1ULL << j;
        }
      }
    }
#pragma unroll
    for (int m = 1; m < kLanes; m <<= 1) {
      word |= __shfl_xor_sync(kFull, word, m);
    }
    if (sub == 0) {
      tile_word[row] = word;
      tile_alive[row] = !pulled;
    }
    __syncthreads();
    unsigned long long live = 0ULL;  // warp 0: the tile's rows still alive
    if (tid < 32) {
      live = (unsigned long long)__ballot_sync(kFull, tile_alive[lane]) |
             (unsigned long long)__ballot_sync(kFull, tile_alive[lane + 32])
                 << 32;
      if (split && lane < kCluster) {  // send the rows it pulled to all
        *cluster.map_shared_rank(&pulled_by[parity][rank], lane) = ~live;
      }
    }
    if (split) {
      // every block's rows are in; the next write to pulled_by[parity] is
      // two split tiles on, after another cluster barrier that every block
      // reaches only once it has read this one
      cluster.sync();
    }

    if (tid < 32) {
      // (c) settle the tile's greedy order in registers: a row is alive
      // when no block pulled it
      const unsigned long long w_lo = tile_word[lane];
      const unsigned long long w_hi = tile_word[lane + 32];
      if (split) {
#pragma unroll
        for (int r = 0; r < kCluster; ++r) live &= ~pulled_by[parity][r];
        parity ^= 1;  // warp 0 alone reads parity
      }
      const unsigned long long busy =
          (unsigned long long)__ballot_sync(kFull, w_lo != 0ULL) |
          (unsigned long long)__ballot_sync(kFull, w_hi != 0ULL) << 32;
      unsigned long long todo = live & busy;
      while (todo != 0ULL) {  // uniform across the warp
        const int i = __ffsll((long long)todo) - 1;
        live &= ~__shfl_sync(kFull, i < 32 ? w_lo : w_hi, i & 31);
        todo = live & busy & ~((2ULL << i) - 1ULL);
      }
      // (d) append the survivors in score order, at most max_out in all
      const int room = max_out - kept;
      const unsigned lo = (unsigned)live;
      const unsigned hi = (unsigned)(live >> 32);
      const unsigned below = (1u << lane) - 1u;
      const int n_lo = __popc(lo);
      if ((lo >> lane) & 1u) {
        const int r = __popc(lo & below);
        if (r < room) {
          kept_box[kept + r] = tile_box[lane];
          kept_area[kept + r] = tile_area[lane];
          if (rank == 0) kb[kept + r] = start + lane;
        }
      }
      if ((hi >> lane) & 1u) {
        const int r = n_lo + __popc(hi & below);
        if (r < room) {
          kept_box[kept + r] = tile_box[lane + 32];
          kept_area[kept + r] = tile_area[lane + 32];
          if (rank == 0) kb[kept + r] = start + lane + 32;
        }
      }
      if (lane == 0) s_kept = kept + min(n_lo + __popc(hi), room);
    }
    __syncthreads();
    last = s_kept - kept;
    kept = s_kept;
  }
  if (rank != 0) return;  // every block holds the same survivors
  for (int s = kept + tid; s < max_out; s += kThreads) kb[s] = 0;
  if (tid == 0) count[img] = kept;
}

constexpr size_t kSmemDefault = 48 * 1024;
// dynamic shared memory per kept box: the box and its area (nms.py MAX_OUT)
constexpr size_t kKeptBytes = sizeof(float4) + sizeof(float);

}  // namespace

// boxes: (batch, n, 4) f32 x1y1x2y2, sorted by score, 16-byte aligned
// (any n: tiles stream from device memory).
// valid: (batch, n) uint8. keep: (batch, max_out) int32 sorted positions
// (0 past the count). count: (batch,) int32 number of kept boxes.
// max_out kept boxes of kKeptBytes each must fit in shared memory.
extern "C" int dc_nms(const void* boxes, const void* valid, int batch, int n,
                      int max_out, float thresh, void* keep, void* count,
                      void* stream) {
  if (batch == 0) return 0;
  const size_t smem = (size_t)max_out * kKeptBytes;
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool zero_skip = thresh >= 0.0f;
  const bool fast = thresh >= kTiny && thresh <= kHuge;
  nms_kernel<<<batch * kCluster, kThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      n, max_out, thresh, zero_skip, fast, static_cast<int*>(keep),
      static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
