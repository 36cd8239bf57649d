// Logo presence score for a batch of frames x fade steps.
//
// Replaces the Pallas TPU kernel _eval_kernel of
// amatsukaze_tpu/ops/logo_pallas.py (evaluate_logo_pallas, pallas_call at
// :107). The arithmetic follows the production jnp path,
// amatsukaze_tpu/ops/logo.py:batched_evaluate_logo, per (frame, fade):
//   work  = fade*(a*src + b*maxv) + (1-fade)*src       (zero outside window)
//   avg   = (sum of the 25 taps of the 5x5 neighbourhood) / 25
//   corr  = sum_k (tap_k - avg) * kernel_k             (per-pixel kernel)
//   s1,s2 = scale[bucket], scale2[bucket], bucket = clamp(int(avg),0,255)>>3
//   score = sum over the mask of clamp(corr*s1, -1, 1) * s2
// The taps and their sums run in the order of the plain PyTorch version,
// each operation rounded on its own (__fmul_rn/__fadd_rn/__fdiv_rn), so a
// pixel's value matches it bit for bit; only the order of the final masked
// sum differs. The bucket is one indexed load of scale[bucket] instead of
// the TPU kernel's 32-way select chain, a workaround for its missing gather.
//
// Layout: one block per (row band, fade, frame). The block erase-blends its
// band of the window plus a 2-row, 2-column zero-filled halo into shared
// memory once, then each thread scores pixels of the band; masked-off
// pixels (about 90% of the window) cost one load. Partial sums land in
// [frame, fade, band] and the wrapper sums the bands, so nothing is
// accumulated across blocks with atomics.
//
// Bound on the H100: at 11 fade steps, operations (about 140 float
// operations per masked pixel and fade against a few bytes per pixel and
// fade); at 2 fade steps, the bytes of the per-pixel tables (kernels and
// both scale tables, ~90 floats per window pixel), which every block reads
// again from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaps = 25;

__global__ void __launch_bounds__(kThreads)
logo_eval_kernel(const float* __restrict__ src, const float* __restrict__ fades,
                 const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ kernels,
                 const float* __restrict__ scale,
                 const float* __restrict__ scale2,
                 const float* __restrict__ mask, float maxv, int n_fades,
                 int height, int width, int band_rows,
                 float* __restrict__ partials) {
  extern __shared__ float work[];  // [band_rows + 4][width + 4]
  const int band = blockIdx.x;
  const int fi = blockIdx.y;
  const int bi = blockIdx.z;
  const int r0 = band * band_rows;
  const int rows = min(band_rows, height - r0);
  const int tw = width + 4;
  const long long plane = static_cast<long long>(height) * width;
  const float fade = __ldg(fades + fi);
  const float keep = __fsub_rn(1.0f, fade);
  const float* s = src + bi * plane;

  for (int i = threadIdx.x; i < (rows + 4) * tw; i += kThreads) {
    const int y = r0 + i / tw - 2;
    const int x = i % tw - 2;
    float v = 0.0f;
    if (y >= 0 && y < height && x >= 0 && x < width) {
      const int q = y * width + x;
      const float xs = __ldg(s + q);
      const float bg = __fadd_rn(__fmul_rn(__ldg(a + q), xs),
                                 __fmul_rn(__ldg(b + q), maxv));
      v = __fadd_rn(__fmul_rn(fade, bg), __fmul_rn(keep, xs));
    }
    work[i] = v;
  }
  __syncthreads();

  float acc = 0.0f;
  for (int i = threadIdx.x; i < rows * width; i += kThreads) {
    const int yy = i / width;
    const int x = i % width;
    const int q = (r0 + yy) * width + x;
    const float m = __ldg(mask + q);
    if (m == 0.0f) continue;
    const float* t = work + yy * tw + x;  // tap (dy, dx) = t[dy*tw + dx]
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) sum = __fadd_rn(sum, t[(k / 5) * tw + k % 5]);
    const float avg = __fdiv_rn(sum, 25.0f);
    float corr = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      corr = __fadd_rn(corr, __fmul_rn(__fsub_rn(t[(k / 5) * tw + k % 5], avg),
                                       __ldg(kernels + k * plane + q)));
    }
    int bucket = static_cast<int>(avg);  // truncation, as XLA's convert
    bucket = min(max(bucket, 0), 255) >> 3;
    const float s1 = __ldg(scale + bucket * plane + q);
    const float s2 = __ldg(scale2 + bucket * plane + q);
    const float nrm = fminf(fmaxf(__fmul_rn(corr, s1), -1.0f), 1.0f);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(nrm, s2), m));
  }

  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ float scratch[kWarps];
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
    partials[(static_cast<long long>(bi) * n_fades + fi) * gridDim.x + band] = total;
  }
}

}  // namespace

// src: [batch, height, width] float32; fades: [n_fades]; a, b, mask:
// [height, width]; kernels: [25, height, width] (tap-major); scale, scale2:
// [32, height, width] (bucket-major); partials: [batch, n_fades, n_bands]
// with n_bands = ceil(height / band_rows). All contiguous float32 on the
// card. Returns cudaGetLastError() after the launch.
extern "C" int amt_logo_eval(const void* src, const void* fades, const void* a,
                             const void* b, const void* kernels,
                             const void* scale, const void* scale2,
                             const void* mask, float maxv, int batch,
                             int n_fades, int height, int width,
                             int band_rows, void* partials, void* stream) {
  if (batch < 1 || n_fades < 1 || height < 1 || width < 1 || band_rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((height + band_rows - 1) / band_rows, n_fades, batch);
  const size_t smem = static_cast<size_t>(band_rows + 4) * (width + 4) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        logo_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  logo_eval_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(fades),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(kernels), static_cast<const float*>(scale),
      static_cast<const float*>(scale2), static_cast<const float*>(mask),
      maxv, n_fades, height, width, band_rows,
      static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}
