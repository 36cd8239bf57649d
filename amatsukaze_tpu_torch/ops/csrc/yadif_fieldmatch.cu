// yadif + field-match combing costs over uint8 frame batches, with an
// optional logo erase applied to the pixels of one box as they are loaded.
//
// Replaces the two Pallas TPU kernels of amatsukaze_tpu/ops/fused_filter.py:
//   make_fused_filter        (frame layout, pallas_call at :335)
//   make_fused_filter_field  (lane-merged field layout, pallas_call at :716,
//                             including the costs_only and logo_box modes)
// Both compute one function; they differ only in how the TPU's (8, 128)
// tiling forced the field split into the lane axis. Here the kernel reads
// the logical frame through a row stride, so neither layout nor padding
// exists: field row y of frame f is frame row 2y (top) / 2y+1 (bottom).
//
// Output frame f (prev = max(f-1, 0), next = min(f+1, B-1)):
//   even rows 2y   : cur[2y]                 (the kept top field)
//   odd rows 2y+1  : clamp(spatial, min(prev[2y+1], next[2y+1]),
//                           max(prev[2y+1], next[2y+1]))
//   spatial = the 5-direction edge-directed average of cur[2y] and cur[2y+2]
//   (cur[2y] again on the last field row), columns edge-replicated.
// All of it is exact in integers (halves are carried as doubled values), so
// the output is bit-identical to the float32 chain of ops.deint.
//
// Costs: for each frame the three combing sums of ops.deint.field_match_costs
// (cur/cur, cur top with prev bottom, prev top with cur bottom), taken over
// odd field rows y < H/2-1 and even field rows y >= 1. The products are
// integers below 2^16, so the sums are exact in 64-bit integers: each block
// writes its own partial [tile, frame, 3] with no atomics, and the host
// wrapper sums the tiles. The result does not depend on the order of the
// sums, so KFM decisions are reproducible from run to run.
//
// Erase: inside the box, x -> clamp(floor(fade*(a*x + b*maxv) + (1-fade)*x
// + 0.5), 0, maxv), each operation rounded on its own (__fmul_rn/__fadd_rn:
// nvcc would otherwise contract pairs into FMAs and move roundings at the .5
// boundaries), as the plain PyTorch erase does.
//
// Bound on the H100: bytes. Each frame is read once from DRAM and written
// once (yadif), or only read (costs); the ~20 integer operations per pixel
// are far below the card's rate. This first version reads every tap straight
// from global memory through the read-only path and leans on L1/L2 for the
// reuse between neighbouring rows, columns and frames (each input row is
// touched by up to three frames' blocks); staging rows in shared memory is
// the next step if the measured time is far from the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Frames {
  const uint8_t* src;
  long long frame_stride;
  long long row_stride;
  int batch, height, width;
};

struct EraseBox {
  const float* a;
  const float* b;
  const float* fades;
  int y0, x0, h, w;
  float maxv;
};

template <bool ERASE>
__device__ __forceinline__ int pixel(const Frames& p, const EraseBox& e,
                                     int f, int r, int x) {
  int v = __ldg(p.src + f * p.frame_stride + r * p.row_stride + x);
  if (ERASE) {
    const int by = r - e.y0;
    const int bx = x - e.x0;
    if (by >= 0 && by < e.h && bx >= 0 && bx < e.w) {
      const float xf = static_cast<float>(v);
      const float fade = __ldg(e.fades + f);
      const float a = __ldg(e.a + by * e.w + bx);
      const float b = __ldg(e.b + by * e.w + bx);
      const float bg = __fadd_rn(__fmul_rn(a, xf), __fmul_rn(b, e.maxv));
      const float t = __fadd_rn(__fmul_rn(fade, bg),
                                __fmul_rn(__fsub_rn(1.0f, fade), xf));
      v = static_cast<int>(
          fminf(fmaxf(floorf(__fadd_rn(t, 0.5f)), 0.0f), e.maxv));
    }
  }
  return v;
}

__device__ __forceinline__ int clamp_col(int x, int w) {
  return x < 0 ? 0 : (x >= w ? w - 1 : x);
}

__device__ __forceinline__ unsigned long long relu_product(int u, int v) {
  const int p = u * v;
  return p > 0 ? static_cast<unsigned long long>(p) : 0ull;
}

__device__ __forceinline__ unsigned long long block_sum(
    unsigned long long v, unsigned long long* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  unsigned long long total = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWarps; ++i) total += scratch[i];
  }
  __syncthreads();
  return total;
}

// grid: (field-row tiles, frames); each block walks its tile's field rows,
// its threads striding along the row (neighbouring threads, neighbouring
// bytes).
template <bool FRAMES, bool COSTS, bool ERASE>
__global__ void __launch_bounds__(kThreads)
yadif_fieldmatch_kernel(Frames p, EraseBox e, uint8_t* __restrict__ out,
                        long long* __restrict__ partials, int tile_rows) {
  const int tile = blockIdx.x;
  const int f = blockIdx.y;
  const int fh = p.height / 2;
  const int w = p.width;
  const int fp = f > 0 ? f - 1 : 0;
  const int fn = f + 1 < p.batch ? f + 1 : p.batch - 1;
  const int y_begin = tile * tile_rows;
  const int y_end = min(y_begin + tile_rows, fh);
  unsigned long long c_cur = 0, c_tp = 0, c_bt = 0;

  for (int y = y_begin; y < y_end; ++y) {
    const int r = 2 * y;
    const bool has_below = y + 1 < fh;
    const int rb = has_below ? r + 2 : r;  // bottom edge: below = keep
    for (int x = threadIdx.x; x < w; x += kThreads) {
      const int t0 = pixel<ERASE>(p, e, f, r, x);       // cur top[y]
      const int bc0 = pixel<ERASE>(p, e, f, r + 1, x);  // cur bottom[y]
      const int pb0 = pixel<ERASE>(p, e, fp, r + 1, x); // prev bottom[y]
      const int t1 = pixel<ERASE>(p, e, f, rb, x);      // cur top[y+1]
      if (FRAMES) {
        int pred2 = t0 + t1;
        int score = abs(t0 - t1);
#pragma unroll
        for (int d = 1; d <= 2; ++d) {
#pragma unroll
          for (int sgn = 1; sgn >= -1; sgn -= 2) {
            const int s = sgn * d;
            const int pa = pixel<ERASE>(p, e, f, r, clamp_col(x + s, w));
            const int pc = pixel<ERASE>(p, e, f, rb, clamp_col(x - s, w));
            const int sc = abs(pa - pc);
            if (sc < score) {
              score = sc;
              pred2 = pa + pc;
            }
          }
        }
        const int tn = pixel<ERASE>(p, e, fn, r + 1, x);  // next bottom[y]
        const int lo = 2 * min(pb0, tn);
        const int hi = 2 * max(pb0, tn);
        const int recon = (min(max(pred2, lo), hi) + 1) >> 1;
        uint8_t* o = out + (static_cast<long long>(f) * p.height + r) * w + x;
        o[0] = static_cast<uint8_t>(t0);
        o[w] = static_cast<uint8_t>(recon);
      }
      if (COSTS) {
        const int pt0 = pixel<ERASE>(p, e, fp, r, x);  // prev top[y]
        if (has_below) {  // odd woven rows 2y+1
          const int pt1 = pixel<ERASE>(p, e, fp, r + 2, x);
          c_cur += relu_product(t0 - bc0, t1 - bc0);
          c_tp += relu_product(t0 - pb0, t1 - pb0);
          c_bt += relu_product(pt0 - bc0, pt1 - bc0);
        }
        if (y >= 1) {  // even woven rows 2y
          const int bcm = pixel<ERASE>(p, e, f, r - 1, x);
          const int pbm = pixel<ERASE>(p, e, fp, r - 1, x);
          c_cur += relu_product(bcm - t0, bc0 - t0);
          c_tp += relu_product(pbm - t0, pb0 - t0);
          c_bt += relu_product(bcm - pt0, bc0 - pt0);
        }
      }
    }
  }

  if (COSTS) {
    __shared__ unsigned long long scratch[kWarps];
    const unsigned long long s0 = block_sum(c_cur, scratch);
    const unsigned long long s1 = block_sum(c_tp, scratch);
    const unsigned long long s2 = block_sum(c_bt, scratch);
    if (threadIdx.x == 0) {
      long long* dst = partials + (static_cast<long long>(tile) * p.batch + f) * 3;
      dst[0] = static_cast<long long>(s0);
      dst[1] = static_cast<long long>(s1);
      dst[2] = static_cast<long long>(s2);
    }
  }
}

template <bool FRAMES, bool COSTS>
void launch(bool erase, dim3 grid, cudaStream_t stream, const Frames& p,
            const EraseBox& e, uint8_t* out, long long* partials,
            int tile_rows) {
  if (erase) {
    yadif_fieldmatch_kernel<FRAMES, COSTS, true>
        <<<grid, kThreads, 0, stream>>>(p, e, out, partials, tile_rows);
  } else {
    yadif_fieldmatch_kernel<FRAMES, COSTS, false>
        <<<grid, kThreads, 0, stream>>>(p, e, out, partials, tile_rows);
  }
}

}  // namespace

// src: [batch, height, width] uint8 with the given frame and row strides
// (elements); out: contiguous [batch, height, width] uint8 or null;
// partials: [ceil(height/2 / tile_rows), batch, 3] int64 or null.
// a_box/b_box: [box_h, box_w] float32 and fades: [batch] float32, or all
// null for no erase. Returns cudaGetLastError() after the launch.
extern "C" int amt_yadif_fieldmatch(
    const void* src, long long frame_stride, long long row_stride, int batch,
    int height, int width, void* out, void* partials, int tile_rows,
    const void* a_box, const void* b_box, const void* fades, int box_y0,
    int box_x0, int box_h, int box_w, float maxv, void* stream) {
  if (batch < 1 || height < 2 || width < 1 || tile_rows < 1 ||
      (out == nullptr && partials == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Frames p{static_cast<const uint8_t*>(src), frame_stride, row_stride,
           batch, height, width};
  EraseBox e{static_cast<const float*>(a_box), static_cast<const float*>(b_box),
             static_cast<const float*>(fades), box_y0, box_x0, box_h, box_w,
             maxv};
  const int fh = height / 2;
  const dim3 grid((fh + tile_rows - 1) / tile_rows, batch);
  const bool erase = a_box != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* o = static_cast<uint8_t*>(out);
  long long* c = static_cast<long long*>(partials);
  if (out != nullptr && partials != nullptr) {
    launch<true, true>(erase, grid, s, p, e, o, c, tile_rows);
  } else if (out != nullptr) {
    launch<true, false>(erase, grid, s, p, e, o, c, tile_rows);
  } else {
    launch<false, true>(erase, grid, s, p, e, o, c, tile_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
