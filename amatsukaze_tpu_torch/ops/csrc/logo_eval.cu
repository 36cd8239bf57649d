// Logo presence score for a batch of frames x fade steps.
//
// Replaces the Pallas TPU kernel _eval_kernel of
// amatsukaze_tpu/ops/logo_pallas.py (evaluate_logo_pallas, pallas_call at
// :107). The arithmetic follows the production jnp path,
// amatsukaze_tpu/ops/logo.py:batched_evaluate_logo, per (frame, fade):
//   work  = fade*(a*src + b*maxv) + (1-fade)*src
//   avg   = (sum of the 25 taps of the 5x5 neighbourhood) / 25
//   corr  = sum_k (tap_k - avg) * kernel_k             (per-pixel kernel)
//   s1,s2 = scale[bucket], scale2[bucket], bucket = clamp(int(avg),0,255)>>3
//   score = sum over the mask of clamp(corr*s1, -1, 1) * s2, / black_score
// The taps and their sums run in the order of the plain PyTorch version,
// each operation rounded on its own (__fmul_rn/__fadd_rn/__fdiv_rn), so a
// masked pixel's value matches it bit for bit; only the order of the final
// sum over the pixels differs, and it is fixed. The bucket is one indexed
// load of scale[bucket] instead of the TPU kernel's 32-way select chain, a
// workaround for its missing gather.
//
// Layout. Only the masked pixels are work (a tenth of the window), so the
// host compacts them once per logo (ops/logo.py:compact_operands): their
// positions in row-major order and their columns of the kernel and scale
// tables, in chunks of one entry per thread, padded with entries of weight
// 0, and per chunk the box of the window that holds its pixels' taps. The
// mask is interior, so no tap leaves the window and nothing is zero-filled
// or bounds-checked. A block is (chunk, frame, group of fades). It
//   1. fills two shared tiles with its chunk's box: the source (for the
//      uint8 entry DeintY is applied here, (a + 2b + c + 2)/4 with the
//      window's first and last row copied: exact in float32) and the
//      background a*src + b*maxv, neither of which depends on the fade;
//   2. each thread takes one masked pixel, holds its 25 source taps and 25
//      background taps in registers, its 25 kernel values in registers or
//      in a column of shared memory, and walks the block's fades with no
//      synchronisation: blend per tap, sum, average, correlate, bucket
//      lookup (coalesced where neighbours share a bucket), clamp;
//   3. sums the pixel values per fade over the block (shuffles, then the
//      warps in order) into partials[frame, fade, chunk];
//   4. takes a ticket from its frame's counter (one integer atomic); the
//      block that draws the last ticket of a frame adds the frame's
//      partials in chunk order, divides by black_score, writes the scores
//      and sets the counter back to 0. No float atomics: the scores do not
//      depend on the order the blocks ran in.
// One launch is the whole call, and it reads the compacted tables (0.9 MB
// for a 96x256 logo, where the dense ones are 9 MB).
//
// Bound on the H100, for 32 frames of a 96x256 logo with 2457 masked
// pixels. Operations: 106 per masked pixel and fade to sum, correlate and
// scale, and 3 per tap pixel to blend, none of which may contract into an
// FMA, so the card's rate for this kernel is half its float32 peak: 0.0028
// ms at 11 fades, 0.0005 at 2. Bytes (windows, A, B, compacted tables,
// scores, each once): 0.0013 ms for the float32 entry, 0.0006 for uint8.
// Operations bind at 11 fades, bytes at 2, where a launch's fixed cost is
// above both. What the kernel really issues is about 250 instructions per
// masked pixel and fade, because every thread blends its own 25 taps (75
// operations; a blended tile in shared memory would cost as many
// instructions to read back, with bank conflicts). At 11 fades the fade
// loop runs near one instruction per clock and scheduler and is two thirds
// of the time; the rest is the chain fill -> barrier -> ... -> fence ->
// ticket -> final sum, which no other work hides at the start and the end
// of a launch this short. What the design does about it: no lane idles on
// a masked-off pixel; the blend's operands stay in registers across the
// fades; one fade's finish (scale, clamp, shuffles) is staggered beside
// the next fade's sums; and the kernel values go to shared memory when the
// launch would otherwise need a second round of blocks (96 registers, five
// blocks of 128 threads per SM, instead of 121 and four).

#include <cuda_runtime.h>
#include <cstdint>

// Built with -DAMT_LOGO_EVAL_STAMPS, thread 0 of every block notes when the
// block began and ended (the card's nanosecond timer), the SM's clock after
// each phase and the SM it ran on; amt_logo_eval_stamps copies the notes
// out (ops/profile_logo_eval.py prints them). The card has no profiler
// that sees inside a kernel.
#ifdef AMT_LOGO_EVAL_STAMPS
constexpr int kStampBlocks = 4096;
constexpr int kStampSlots = 8;
__device__ long long g_stamps[kStampBlocks * kStampSlots];
__device__ __forceinline__ void stamp(int slot) {
  if (threadIdx.x != 0) return;
  const int block = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (block >= kStampBlocks) return;
  long long t;
  if (slot == 0 || slot == 7) {
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  } else if (slot == 6) {
    unsigned sm;
    asm volatile("mov.u32 %0, %smid;" : "=r"(sm));
    t = sm;
  } else {
    t = clock64();
  }
  g_stamps[block * kStampSlots + slot] = t;
}
#define STAMP(slot) stamp(slot)
#else
#define STAMP(slot)
#endif

namespace {

constexpr int kTaps = 25;
constexpr int kMaxFadesPerBlock = 16;

// DeintY of element q of one frame's raw uint8 window.
__device__ __forceinline__ float deint_u8(const uint8_t* __restrict__ u, int q,
                                          int width, int plane) {
  const int c = __ldg(u + q);
  if (q < width || q >= plane - width) return static_cast<float>(c);
  const int s = __ldg(u + q - width) + 2 * c + __ldg(u + q + width) + 2;
  return __fmul_rn(static_cast<float>(s), 0.25f);
}

// The same for elements q..q+3 of one row, q a multiple of 4 and the frame
// 4-byte aligned: one word per row.
__device__ __forceinline__ float4 deint_u8x4(const uint8_t* __restrict__ u,
                                             int q, int width, int plane) {
  const uint32_t c = __ldg(reinterpret_cast<const uint32_t*>(u + q));
  float4 x;
  if (q < width || q >= plane - width) {
    x.x = static_cast<float>(c & 255u);
    x.y = static_cast<float>((c >> 8) & 255u);
    x.z = static_cast<float>((c >> 16) & 255u);
    x.w = static_cast<float>(c >> 24);
    return x;
  }
  const uint32_t up = __ldg(reinterpret_cast<const uint32_t*>(u + q - width));
  const uint32_t dn = __ldg(reinterpret_cast<const uint32_t*>(u + q + width));
  float out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t s = ((up >> (8 * i)) & 255u) + 2u * ((c >> (8 * i)) & 255u) +
                       ((dn >> (8 * i)) & 255u) + 2u;
    out[i] = __fmul_rn(static_cast<float>(s), 0.25f);
  }
  return make_float4(out[0], out[1], out[2], out[3]);
}

template <bool kU8, int kThreads, int kMinBlocks, bool kKernelsInRegisters>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
logo_eval_kernel(const void* __restrict__ src_, const float* __restrict__ fades,
                 const float* __restrict__ a, const float* __restrict__ b,
                 const int* __restrict__ pos, const int4* __restrict__ boxes,
                 const float* __restrict__ weight,
                 const float* __restrict__ kernels,
                 const float* __restrict__ scale,
                 const float* __restrict__ scale2, float maxv,
                 float black_score, int n_fades, int fades_per_block,
                 int height, int width, int m_pad, int tile_elems,
                 float* partials, float* __restrict__ values, int* tickets,
                 float* __restrict__ scores) {
  // the chunk's box of the window, [rows][cols] source and [rows][cols]
  // background; behind tile_elems of each, where they are not in
  // registers, the threads' kernel values [25][kThreads]
  extern __shared__ __align__(16) float tile[];
  constexpr int kWarps = kThreads / 32;
  __shared__ float warp_sums[kMaxFadesPerBlock][kWarps];
  __shared__ int is_last;

  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int bi = blockIdx.y;
  const int f0 = blockIdx.z * fades_per_block;
  const int nf = min(fades_per_block, n_fades - f0);
  const int tid = threadIdx.x;
  const int j = chunk * kThreads + tid;
  const int plane = height * width;

  STAMP(0);  // begin (ns)
  STAMP(6);  // SM
  STAMP(1);
  const int my_pos = __ldg(pos + j);
  const float wgt = __ldg(weight + j);
  // the pixel's kernel values depend on nothing the block computes: their
  // loads go out first and land while the tiles are filled (where they go
  // to shared memory they are loaded later: held meanwhile they would
  // spill)
  float ker[kTaps];
  if (kKernelsInRegisters) {
#pragma unroll
    for (int k = 0; k < kTaps; ++k) ker[k] = __ldg(kernels + k * m_pad + j);
  }
  // the box of the window that holds this chunk's taps: row0, rows, col0,
  // cols
  const int4 box = __ldg(boxes + chunk);
  const int cols = box.w;
  const int q0 = box.x * width + box.z;
  const int n_tile = box.y * cols;
  float* xs_t = tile;
  float* bg_t = tile + n_tile;

  const float* sf = static_cast<const float*>(src_) + static_cast<size_t>(bi) * plane;
  const uint8_t* su = static_cast<const uint8_t*>(src_) + static_cast<size_t>(bi) * plane;
  // col0 and cols are multiples of 4 where the width is one
  const bool vec = (width % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(b) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(src_) % 16 == 0);
  // volatile: the loads stay in the fade loop, where the compiler would
  // lift them out of it and hold the values in registers after all
  volatile float* my_kernels = tile + 2 * tile_elems + tid;
  if (vec) {
    // four elements of a row per thread and step, and the loads of kFill
    // steps in flight together
    constexpr int kFill = 2;
    for (int base = tid * 4; base < n_tile; base += kFill * kThreads * 4) {
      float4 x[kFill], av[kFill], bv[kFill];
#pragma unroll
      for (int s = 0; s < kFill; ++s) {
        const int i = base + s * kThreads * 4;
        if (i < n_tile) {
          const int q = q0 + i / cols * width + i % cols;
          if (kU8) {
            x[s] = deint_u8x4(su, q, width, plane);
          } else {
            x[s] = __ldg(reinterpret_cast<const float4*>(sf + q));
          }
          av[s] = __ldg(reinterpret_cast<const float4*>(a + q));
          bv[s] = __ldg(reinterpret_cast<const float4*>(b + q));
        }
      }
#pragma unroll
      for (int s = 0; s < kFill; ++s) {
        const int i = base + s * kThreads * 4;
        if (i < n_tile) {
          float4 g;
          g.x = __fadd_rn(__fmul_rn(av[s].x, x[s].x), __fmul_rn(bv[s].x, maxv));
          g.y = __fadd_rn(__fmul_rn(av[s].y, x[s].y), __fmul_rn(bv[s].y, maxv));
          g.z = __fadd_rn(__fmul_rn(av[s].z, x[s].z), __fmul_rn(bv[s].z, maxv));
          g.w = __fadd_rn(__fmul_rn(av[s].w, x[s].w), __fmul_rn(bv[s].w, maxv));
          *reinterpret_cast<float4*>(xs_t + i) = x[s];
          *reinterpret_cast<float4*>(bg_t + i) = g;
        }
      }
    }
  } else {
    for (int i = tid; i < n_tile; i += kThreads) {
      const int q = q0 + i / cols * width + i % cols;
      const float x = kU8 ? deint_u8(su, q, width, plane) : __ldg(sf + q);
      xs_t[i] = x;
      bg_t[i] = __fadd_rn(__fmul_rn(__ldg(a + q), x), __fmul_rn(__ldg(b + q), maxv));
    }
  }
  if (!kKernelsInRegisters) {
    // a column of its own: no bank conflict
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      my_kernels[k * kThreads] = __ldg(kernels + k * m_pad + j);
    }
  }
  __syncthreads();
  STAMP(3);  // tiles filled

  // one masked pixel per thread: tap (dy, dx) = tile[t0 + dy*cols + dx]
  const int t0 = (my_pos / width - box.x - 2) * cols + my_pos % width - box.z - 2;
  float xs[kTaps], bg[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int off = t0 + (k / 5) * cols + k % 5;
    xs[k] = xs_t[off];
    bg[k] = bg_t[off];
  }

  // One fade's chain of dependent work is long (two sums of 25 in order, a
  // division, a table load that waits for the average, five shuffles), and
  // a thread has nothing else to do meanwhile. So the loop is staggered:
  // `correlate` of fade f stands beside `finish` of fade f - 1 in one
  // straight body, and the two interleave.
  float corr, s1, s2;
  auto correlate = [&](int fl) {
    const float fade = __ldg(fades + f0 + fl);
    const float keep = __fsub_rn(1.0f, fade);
    float v[kTaps];
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      v[k] = __fadd_rn(__fmul_rn(fade, bg[k]), __fmul_rn(keep, xs[k]));
      sum = __fadd_rn(sum, v[k]);
    }
    const float avg = __fdiv_rn(sum, 25.0f);
    int bucket = static_cast<int>(avg);  // truncation, as XLA's convert
    bucket = min(max(bucket, 0), 255) >> 3;
    s1 = __ldg(scale + bucket * m_pad + j);
    s2 = __ldg(scale2 + bucket * m_pad + j);
    corr = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      // from shared memory: 25 registers less and five blocks to an SM
      // instead of four, for one conflict-free load more per tap and fade
      const float kv = kKernelsInRegisters ? ker[k] : my_kernels[k * kThreads];
      corr = __fadd_rn(corr, __fmul_rn(__fsub_rn(v[k], avg), kv));
    }
  };
  auto finish = [&](int fl, float c, float t1, float t2) {
    const float nrm = fminf(fmaxf(__fmul_rn(c, t1), -1.0f), 1.0f);
    float val = __fmul_rn(__fmul_rn(nrm, t2), wgt);
    if (values != nullptr) {
      values[(static_cast<size_t>(bi) * n_fades + f0 + fl) * m_pad + j] = val;
    }
    for (int off = 16; off > 0; off >>= 1) {
      val = __fadd_rn(val, __shfl_down_sync(0xffffffffu, val, off));
    }
    if ((tid & 31) == 0) warp_sums[fl][tid >> 5] = val;
  };
  correlate(0);
  for (int fl = 1; fl < nf; ++fl) {
    const float c = corr, t1 = s1, t2 = s2;
    correlate(fl);
    finish(fl - 1, c, t1, t2);
  }
  finish(nf - 1, corr, s1, s2);
  __syncthreads();
  STAMP(4);  // taps gathered, fades walked

  if (tid < nf) {
    float total = warp_sums[tid][0];
    for (int w = 1; w < kWarps; ++w) total = __fadd_rn(total, warp_sums[tid][w]);
    partials[(static_cast<size_t>(bi) * n_fades + f0 + tid) * n_chunks + chunk] = total;
    __threadfence();  // the partial is visible before the ticket is drawn
  }
  __syncthreads();
  if (tid == 0) {
    const int blocks_per_frame = n_chunks * gridDim.z;
    is_last = atomicAdd(tickets + bi, 1) == blocks_per_frame - 1;
  }
  __syncthreads();
  STAMP(5);  // partials written, ticket drawn
  STAMP(7);  // end (ns), unless this block goes on to add its frame's up
  if (!is_last) return;

  // every block of this frame has written its partials. They come into
  // shared memory in one go (the tiles are done with), then thread f adds
  // fade f's in chunk order
  __threadfence();
  const int fades_per_pass = 2 * tile_elems / n_chunks;  // >= 1
  for (int fa = 0; fa < n_fades; fa += fades_per_pass) {
    const int n = min(fades_per_pass, n_fades - fa);
    const float* p = partials + (static_cast<size_t>(bi) * n_fades + fa) * n_chunks;
    for (int i = tid; i < n * n_chunks; i += kThreads) tile[i] = __ldcg(p + i);
    __syncthreads();
    for (int f = tid; f < n; f += kThreads) {
      float total = tile[f * n_chunks];
      for (int c = 1; c < n_chunks; ++c) total = __fadd_rn(total, tile[f * n_chunks + c]);
      scores[bi * n_fades + fa + f] = __fdiv_rn(total, black_score);
    }
    __syncthreads();
  }
  if (tid == 0) tickets[bi] = 0;  // ready for the next launch
  STAMP(7);
}

using Launcher = cudaError_t (*)(dim3, size_t, cudaStream_t, const void*,
                                 const float*, const float*, const float*,
                                 const int*, const int4*, const float*,
                                 const float*, const float*, const float*,
                                 float, float, int,
                                 int, int, int, int, int, float*, float*, int*,
                                 float*);

template <bool kU8, int kThreads, int kMinBlocks, bool kKernelsInRegisters>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const void* src,
                   const float* fades, const float* a, const float* b,
                   const int* pos, const int4* boxes, const float* weight,
                   const float* kernels,
                   const float* scale, const float* scale2, float maxv,
                   float black_score, int n_fades, int fades_per_block,
                   int height, int width, int m_pad, int tile_elems,
                   float* partials, float* values, int* tickets,
                   float* scores) {
  auto kernel = logo_eval_kernel<kU8, kThreads, kMinBlocks, kKernelsInRegisters>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(
      src, fades, a, b, pos, boxes, weight, kernels, scale, scale2, maxv,
      black_score, n_fades, fades_per_block, height, width, m_pad, tile_elems, partials,
      values, tickets, scores);
  return cudaGetLastError();
}

// threads per block x where the 25 kernel values of a pixel live: in
// registers (at most 128 a thread, 512 threads resident per SM) or in
// shared memory (at most 102, 640 threads)
template <bool kU8>
Launcher pick(int threads, int kernels_in_registers) {
  switch (threads) {
    case 64:
      return kernels_in_registers ? launch<kU8, 64, 8, true>
                                  : launch<kU8, 64, 10, false>;
    case 128:
      return kernels_in_registers ? launch<kU8, 128, 4, true>
                                  : launch<kU8, 128, 5, false>;
    case 256:
      return kernels_in_registers ? launch<kU8, 256, 2, true> : nullptr;
    default:
      return nullptr;
  }
}

}  // namespace

// src: [batch, height, width], float32 (the deinterlaced window) or, with
// src_is_u8, uint8 (the raw window; DeintY is applied while it is loaded).
// fades: [n_fades]; a, b: [height, width]; pos: [m_pad] int32 in chunks of
// `threads` entries, interior; boxes: [m_pad / threads, 4] int32 (row0,
// rows, col0, cols), each holding every tap of its chunk in at most
// tile_elems pixels, 16-byte aligned; weight: [m_pad]; kernels: [25, m_pad]; scale, scale2: [32, m_pad];
// partials: [batch, n_fades, m_pad / threads] scratch; values: null or
// [batch, n_fades, m_pad], each entry's share of the raw score; tickets:
// [batch] int32, zero before the first launch and again after every one;
// scores: [batch, n_fades]. All contiguous on the card. Returns
// cudaGetLastError() after the launch.
extern "C" int amt_logo_eval(const void* src, int src_is_u8, const void* fades,
                             const void* a, const void* b, const void* pos,
                             const void* boxes, const void* weight, const void* kernels,
                             const void* scale, const void* scale2, float maxv,
                             float black_score, int batch, int n_fades,
                             int fades_per_block, int height, int width,
                             int m_pad, int threads, int kernels_in_registers,
                             int tile_elems, void* partials, void* values,
                             void* tickets, void* scores, void* stream) {
  if (batch < 1 || batch > 65535 || n_fades < 1 || fades_per_block < 1 ||
      fades_per_block > kMaxFadesPerBlock || height < 5 || width < 5 ||
      m_pad < threads || m_pad % threads != 0 || tile_elems < 25 ||
      m_pad / threads > 2 * tile_elems ||
      reinterpret_cast<uintptr_t>(boxes) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launcher fn = src_is_u8 ? pick<true>(threads, kernels_in_registers)
                                : pick<false>(threads, kernels_in_registers);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (n_fades + fades_per_block - 1) / fades_per_block;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(m_pad / threads, batch, splits);
  const size_t smem =
      (static_cast<size_t>(2) * tile_elems +
       (kernels_in_registers ? 0 : kTaps * threads)) * sizeof(float);
  return static_cast<int>(fn(
      grid, smem, static_cast<cudaStream_t>(stream), src,
      static_cast<const float*>(fades), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const int*>(pos),
      static_cast<const int4*>(boxes), static_cast<const float*>(weight), static_cast<const float*>(kernels),
      static_cast<const float*>(scale), static_cast<const float*>(scale2),
      maxv, black_score, n_fades, fades_per_block, height, width, m_pad,
      tile_elems, static_cast<float*>(partials), static_cast<float*>(values),
      static_cast<int*>(tickets), static_cast<float*>(scores)));
}

#ifdef AMT_LOGO_EVAL_STAMPS
// out: kStampBlocks x kStampSlots int64 on the host.
extern "C" int amt_logo_eval_stamps(void* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)));
}
#endif
