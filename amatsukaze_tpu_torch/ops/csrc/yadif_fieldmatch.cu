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
// With the bottom field kept (frames only: no costs, no erase), the rows
// swap roles: odd rows 2y+1 are cur[2y+1], even rows 2y are rebuilt from
// cur[2y-1] above (cur[1] again on the first field row) and cur[2y+1]
// below, clamped by prev[2y] and next[2y]. The direction search takes
// `above` and `below` in that order, as ops.deint.yadif_deinterlace(...,
// parity_top=False) does: its ties go as there (a vertical flip of the
// top-field branch would break them the other way).
// Costs: for each frame the three combing sums of ops.deint.field_match_costs
// (cur/cur, cur top with prev bottom, prev top with cur bottom), taken over
// odd field rows y < H/2-1 and even field rows y >= 1.
// Erase: inside the box, x -> clamp(floor(fade*(a*x + b*maxv) + (1-fade)*x
// + 0.5), 0, maxv), each operation rounded on its own (__fmul_rn/__fadd_rn:
// nvcc would otherwise contract pairs into FMAs and move roundings at the .5
// boundaries), as the plain PyTorch erase does.
//
// Bound on the H100: bytes first (each frame read once and written once for
// yadif, only read for the costs: 106 MB at 3.35 TB/s for a 34x1080x1440
// batch is 0.032 ms; a device-to-device copy of the same bytes takes 0.041
// ms on the card), with the integer pipes close behind: the rebuilt row
// costs about 20 instructions per pixel on packed bytes and the three cost
// sums about 7, and at those counts the arithmetic of a batch needs about
// as long as its bytes. The measured kernels are bound by instructions,
// not by bytes (a register-double-buffered loop that hides the load latency
// made them slower, fewer registers made them faster). So the design cuts both
// the load instructions and the arithmetic instructions:
//
// * A thread owns 16 consecutive columns (one "word") and loads each row of
//   them as one uint4; neighbouring lanes take neighbouring words, so a warp
//   moves 512 contiguous bytes per load. Output rows are stored as uint4.
//   Pointers or strides that are not 16-byte aligned take the same kernel
//   with the word assembled from byte loads (VEC = false), and a row's last
//   partial word (W % 16 != 0) is always assembled that way, padded with its
//   last pixel, which is also the column edge replication.
// * A thread walks its strip of field rows with a sliding window in
//   registers: top[y+1] becomes top[y], and the same for the previous
//   frame's top rows (the rows a field row adds are locals of the loop body:
//   carried across it they cost the costs variant a fifth of its speed).
//   Each row word is loaded once per strip; only the
//   strip's one-row halo is loaded twice (from L1/L2). Per 16 pixels of a
//   field row that is 3 word loads in frames mode, 4 in costs mode, 5 in
//   both, against 12 and 8 byte loads per pixel before.
// * The +-1 / +-2 column taps come from the neighbouring lanes' registers
//   (__shfl_up/down of the edge 32 bits); a warp's first and last lane fetch
//   their neighbour word themselves (an L1 hit), and columns 0 and W-1
//   replicate.
// * Arithmetic is on four packed bytes at a time where that is exact:
//   (clamp(p2, 2lo, 2hi) + 1) >> 1 == clamp((p2 + 1) >> 1, lo, hi), so the
//   prediction is the rounded-up byte average (__vavgu4) of the winning
//   pair of taps; the direction search is __vabsdiffu4 with __vcmpltu4
//   masks, in the order and with the strict '<' of
//   ops.deint._spatial_pred, and keeps the winner's two taps so that one
//   average serves all five directions; the temporal clamp is three
//   compares and selects. Output is bit-identical to the float32 chain of
//   ops.deint.
// * Costs: every cost is the combing of a weave (cur top with cur bottom,
//   cur top with prev bottom, prev top with cur bottom): the sum over the
//   woven rows m, between their neighbours u and l, of
//   relu((u - m) * (l - m)). With 2 * relu(x) = |x| + x that is half of
//   |u - m| * |l - m| + u*l + m*m - u*m - m*l, five sums of products of
//   bytes with no compare and no select (__vcmpltu4 is emulated on Hopper,
//   __dp4a is one instruction for four products). Each step down a weave
//   (its __vabsdiffu4 and its u*m dot) is computed once and serves the rows
//   above and below it, and the u*l and m*m dots are shared between the
//   weaves that have those rows in common: per 16 pixels of a field row 24
//   __vabsdiffu4 and 80 __dp4a for the three costs. A thread's sums stay in
//   uint32 (bound below) and widen to 64 bits only in the block reduction.
//   Each block writes its own partial [tile, frame, 3] with no atomics and
//   the host wrapper sums the tiles: the result does not depend on launch
//   order, so KFM decisions are reproducible from run to run.
// * The erase box is applied once, after a row word is loaded: a block
//   whose rows miss the box skips it with one uniform branch, a word whose
//   row or 16 columns miss the box with one test, and the words inside go
//   through one function that is not inlined (inlined at every load it
//   cost 70 registers and halved the occupancy of every block). The blocks
//   that meet the box run several times longer than the others, so the
//   erase variants take a one-dimensional grid and map its first indices
//   to those blocks: they start first and the light blocks fill the SMs
//   around them (in grid order the last frame's box blocks started last
//   and the launch waited a third longer for them alone).
// * Grid: (field-row tiles, frames); a block is one tile of `tile_rows` field
//   rows over the full width, its threads laid out as `strips` row strips of
//   n_words = ceil(W/16) threads each (1440 wide: 2 strips x 90 = 180 of 192
//   threads; 720 wide: 4 x 45 = 180 of 192). tile_rows, strips and the
//   thread count come from the host wrapper (ops/fused_filter.py:
//   launch_geometry), which holds the tile count and the partials' shape.
//   Frames only, tile_rows = 8: a 34x1080x1440 batch is 68 x 34 = 2312
//   blocks and a 34x540x720 batch 34 x 34 = 1156 blocks (8.8 per SM of 132;
//   five blocks of 64-register threads are resident per SM, each thread
//   with three 16-byte loads in flight per row: 43 KB per SM, about three
//   times what 3.35 TB/s needs at a microsecond of latency). With costs,
//   tile_rows = 24: 23 x 33 = 759 blocks, three resident per SM, so the
//   launch is just under two full rounds of 396 blocks.
// * Frames f-1, f, f+1 are each read by three blocks (as prev, cur, next).
//   A block does not walk frames: the blocks of neighbouring frames run at
//   about the same time and the 50 MB L2 serves the second and third read
//   (timed with inputs rotating through more than the L2, the kernel moves
//   its once-only bytes at about 2 TB/s, so the repeats do not come from
//   DRAM).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kWord = 16;  // bytes (pixels) per thread and row
constexpr unsigned kFull = 0xffffffffu;
// A thread's uint32 sum takes in at most 6 x 16 products of at most 255^2
// per cost, field row and word (three sums of products added for each of
// the two woven rows, two subtracted); counting them all, it cannot
// overflow up to this many row-words.
constexpr long long kMaxRowWords = 688;
static_assert(kMaxRowWords * 6 * kWord * 255 * 255 <= 0xffffffffLL,
              "uint32 cost sums would overflow");

struct Params {
  const uint8_t* src;
  long long frame_stride;
  long long row_stride;
  int batch, height, width;
  uint8_t* out;
  long long* partials;
  int tile_rows;       // field rows per block
  int strips;          // row strips per block
  int rows_per_strip;  // ceil(tile_rows / strips)
  int n_words;         // ceil(width / 16)
  int n_chunks;        // column chunks when n_words > blockDim.x
  int vec_out;         // out rows are 16-byte aligned
  // erase box
  const float* a;
  const float* b;
  const float* fades;
  int y0, x0, box_h, box_w;
  float maxv;
  int n_tiles;     // field-row tiles per frame
  int box_tile0;   // first tile whose rows meet the box
  int box_tiles;   // number of such tiles
  int bottom;      // keep the bottom field (frames only)
};

struct Row {
  uint32_t w[4];
};

// The 16 pixels of word c of row r of frame f, as stored. Bytes past the
// row's end hold the row's last pixel (the column edge replication that the
// spatial prediction needs) or, with ZERO_PAD, zero (so that they add
// nothing to the cost sums).
template <bool VEC, bool ZERO_PAD>
__device__ __forceinline__ Row load_raw(const Params& p, int f, int r, int c) {
  const uint8_t* row = p.src + f * p.frame_stride + r * p.row_stride;
  const int x = c * kWord;
  const int n = min(kWord, p.width - x);  // valid bytes
  Row v;
  if (VEC && n == kWord) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(row + x));
    v.w[0] = q.x;
    v.w[1] = q.y;
    v.w[2] = q.z;
    v.w[3] = q.w;
  } else {
    uint32_t last = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (4 * j + k < n) {
          last = __ldg(row + x + 4 * j + k);
        } else if (ZERO_PAD) {
          last = 0;
        }
        word |= last << (8 * k);
      }
      v.w[j] = word;
    }
  }
  return v;
}

// Zero the word's bytes from the n-th on.
__device__ __forceinline__ void zero_past(Row& v, int n) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int left = n - 4 * j;
    if (left < 4) v.w[j] &= left <= 0 ? 0u : (1u << (8 * left)) - 1u;
  }
}

// The erase of one word that meets the box: a and b point at the box row,
// bx0 is the word's first column relative to the box. Not inlined: it is
// called from many places and runs for few words. All 16 pixels are
// computed (the a/b loads clamped into the row, so that they can be started
// together) and the ones outside the box keep their value.
__device__ __noinline__ Row erase_box_word(Row v, const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           float fade, int bx0, int box_w,
                                           int n, float maxv) {
  float av[kWord], bv[kWord];
#pragma unroll
  for (int i = 0; i < kWord; ++i) {
    const int bx = min(max(bx0 + i, 0), box_w - 1);
    av[i] = __ldg(a + bx);
    bv[i] = __ldg(b + bx);
  }
  const float keep = __fsub_rn(1.0f, fade);
  uint32_t last = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = 4 * j + k;
      const uint32_t raw = (v.w[j] >> (8 * k)) & 0xffu;
      const float xf = static_cast<float>(raw);
      const float bg =
          __fadd_rn(__fmul_rn(av[i], xf), __fmul_rn(bv[i], maxv));
      const float t = __fadd_rn(__fmul_rn(fade, bg), __fmul_rn(keep, xf));
      const uint32_t erased = static_cast<uint32_t>(
          fminf(fmaxf(floorf(__fadd_rn(t, 0.5f)), 0.0f), maxv));
      const bool in_box = bx0 + i >= 0 && bx0 + i < box_w;
      if (i < n) last = in_box ? erased : raw;
      word |= last << (8 * k);
    }
    v.w[j] = word;
  }
  return v;
}

// Erase the word's pixels that lie in the box (none for most words: one
// test of the row and the 16 columns). Kept apart from the load so that a
// thread's loads are all under way before the first of these branches.
__device__ __forceinline__ void erase_word(const Params& p, Row& v, int f,
                                           int r, int c, bool zero_pad) {
  const int by = r - p.y0;
  const int x = c * kWord;
  if (by < 0 || by >= p.box_h || x >= p.x0 + p.box_w || x + kWord <= p.x0) {
    return;
  }
  const int n = min(kWord, p.width - x);
  v = erase_box_word(v, p.a + by * p.box_w, p.b + by * p.box_w,
                     __ldg(p.fades + f), x - p.x0, p.box_w, n, p.maxv);
  if (zero_pad && n < kWord) zero_past(v, n);
}

template <bool VEC, bool ERASE>
__device__ __forceinline__ Row load_word(const Params& p, int f, int r, int c,
                                         bool erase) {
  Row v = load_raw<VEC, false>(p, f, r, c);
  if (ERASE && erase) erase_word(p, v, f, r, c, false);
  return v;
}

// What field row y adds to a thread's window: top[y+1] of the current and
// the previous frame, bottom[y] of the previous, current and next frame.
// With the bottom field kept (TOP false) t1 is bottom[y] of the current
// frame (the kept row below the rebuilt row 2y) and pb0/nb0 are top[y] of
// the previous and next frame (the rebuilt row's temporal taps).
struct NewRows {
  Row t1, pt1, pb0, b0, nb0;
};

// The kept row above the rebuilt row of field row y (frame rows).
template <bool TOP>
__device__ __forceinline__ int kept_above(int y) {
  return TOP ? 2 * y : 2 * max(y - 1, 0) + 1;
}

template <bool FRAMES, bool COSTS, bool ERASE, bool VEC, bool TOP>
__device__ __forceinline__ NewRows load_rows(const Params& p, int f, int fp,
                                             int fn, int y, int c,
                                             bool erase) {
  NewRows n = {};
  const int r = 2 * y;
  const bool below = !TOP || y + 1 < p.height / 2;
  const int r_keep = TOP ? r + 2 : r + 1;  // the kept row below
  const int r_miss = TOP ? r + 1 : r;      // the rebuilt row
  // top rows keep the replicated edge when frames are rebuilt from them
  constexpr bool kTopZero = !FRAMES;
  if (below) {
    n.t1 = load_raw<VEC, kTopZero>(p, f, r_keep, c);
    if (COSTS) n.pt1 = load_raw<VEC, true>(p, fp, r + 2, c);
  }
  n.pb0 = load_raw<VEC, COSTS>(p, fp, r_miss, c);
  if (COSTS) n.b0 = load_raw<VEC, true>(p, f, r + 1, c);
  if (FRAMES) n.nb0 = load_raw<VEC, COSTS>(p, fn, r_miss, c);
  if (ERASE && erase) {
    if (below) {
      erase_word(p, n.t1, f, r + 2, c, kTopZero);
      if (COSTS) erase_word(p, n.pt1, fp, r + 2, c, true);
    }
    erase_word(p, n.pb0, fp, r + 1, c, COSTS);
    if (COSTS) erase_word(p, n.b0, f, r + 1, c, true);
    if (FRAMES) erase_word(p, n.nb0, fn, r + 1, c, COSTS);
  }
  return n;
}

// The 32 bits left and right of a thread's word: columns 16c-4..16c-1 and
// 16c+16..16c+19, from the neighbouring lanes, with the row's first and last
// pixel replicated past its ends. Every lane of the warp must call this.
template <bool VEC, bool ERASE>
__device__ __forceinline__ void aprons(const Params& p, const Row& v, int f,
                                       int r, int c, bool active, bool erase,
                                       uint32_t& left, uint32_t& right) {
  const int lane = threadIdx.x & 31;
  left = __shfl_up_sync(kFull, v.w[3], 1);
  right = __shfl_down_sync(kFull, v.w[0], 1);
  if (!active) return;
  if (c == 0) {
    left = (v.w[0] & 0xffu) * 0x01010101u;
  } else if (lane == 0) {
    left = load_word<VEC, ERASE>(p, f, r, c - 1, erase).w[3];
  }
  if (c == p.n_words - 1) {
    right = (v.w[3] >> 24) * 0x01010101u;
  } else if (lane == 31) {
    right = load_word<VEC, ERASE>(p, f, r, c + 1, erase).w[0];
  }
}

// One direction of the spatial search on four pixels: a strictly better
// score takes over, as in ops.deint._spatial_pred. The winner's two taps
// are kept and averaged once at the end.
__device__ __forceinline__ void try_direction(uint32_t pa, uint32_t pc,
                                              uint32_t& score, uint32_t& a,
                                              uint32_t& c) {
  const uint32_t sc = __vabsdiffu4(pa, pc);
  const uint32_t better = __vcmpltu4(sc, score);
  a = (pa & better) | (a & ~better);
  c = (pc & better) | (c & ~better);
  score = (sc & better) | (score & ~better);
}

// The rebuilt bottom row: above/below are the kept field's rows with their
// aprons ([0] left, [1..4] the word, [5] right).
__device__ __forceinline__ Row rebuild(const uint32_t (&A)[6],
                                       const uint32_t (&C)[6], const Row& tp,
                                       const Row& tn) {
  Row out;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t a = A[j + 1];
    uint32_t c = C[j + 1];
    uint32_t score = __vabsdiffu4(a, c);
    // above[x + s] with below[x - s] for s = +1, -1, +2, -2
    try_direction(__funnelshift_r(A[j + 1], A[j + 2], 8),
                  __funnelshift_r(C[j], C[j + 1], 24), score, a, c);
    try_direction(__funnelshift_r(A[j], A[j + 1], 24),
                  __funnelshift_r(C[j + 1], C[j + 2], 8), score, a, c);
    try_direction(__funnelshift_r(A[j + 1], A[j + 2], 16),
                  __funnelshift_r(C[j], C[j + 1], 16), score, a, c);
    try_direction(__funnelshift_r(A[j], A[j + 1], 16),
                  __funnelshift_r(C[j + 1], C[j + 2], 16), score, a, c);
    // clamp(avg, min(tp, tn), max(tp, tn)) with one compare for both ends
    const uint32_t pred = __vavgu4(a, c);
    const uint32_t swap = __vcmpltu4(tn.w[j], tp.w[j]);
    const uint32_t lo = (tn.w[j] & swap) | (tp.w[j] & ~swap);
    const uint32_t hi = (tp.w[j] & swap) | (tn.w[j] & ~swap);
    const uint32_t under = __vcmpltu4(pred, lo);
    const uint32_t over = __vcmpltu4(hi, pred);
    out.w[j] = (lo & under) | (hi & over) | (pred & ~(under | over));
  }
  return out;
}

// sum over the word of a * b, pixel by pixel
__device__ __forceinline__ uint32_t dot(const uint32_t (&a)[4],
                                        const uint32_t (&b)[4]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) acc = __dp4a(a[j], b[j], acc);
  return acc;
}

// Two vertically adjacent rows of a weave, upper and lower: per pixel
// |upper - lower|, and the sum over the word of upper * lower.
struct Step {
  uint32_t abs[4];
  uint32_t dot;
};

__device__ __forceinline__ Step step(const Row& upper, const Row& lower) {
  Step d;
#pragma unroll
  for (int j = 0; j < 4; ++j) d.abs[j] = __vabsdiffu4(upper.w[j], lower.w[j]);
  d.dot = dot(upper.w, lower.w);
  return d;
}

// Adds one woven row m between its neighbours u and l to `twice`, a
// thread's share of twice a cost. With 2 * relu(x) = |x| + x:
//   2 * relu((u - m) * (l - m)) = |u - m| * |l - m| + u*l + m*m - u*m - m*l,
// all sums of products of bytes, with no compare: `up` and `down` are the
// steps (u, m) and (m, l), `skip` is the sum of u * l and `square` of m * m.
// The differences never go below zero: the sum is added before the two
// dots are taken off, and each row's total is a sum of relus.
__device__ __forceinline__ void comb(uint32_t& twice, const Step& up,
                                     const Step& down, uint32_t skip,
                                     uint32_t square) {
  twice += dot(up.abs, down.abs) + skip + square - up.dot - down.dot;
}

__device__ __forceinline__ void store_word(const Params& p, int f, int r,
                                           int c, const Row& v) {
  const int x = c * kWord;
  const int n = min(kWord, p.width - x);
  uint8_t* o = p.out + (static_cast<long long>(f) * p.height + r) * p.width + x;
  if (p.vec_out && n == kWord) {
    *reinterpret_cast<uint4*>(o) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kWord; ++i) {
      if (i < n) o[i] = static_cast<uint8_t>(v.w[i / 4] >> (8 * (i % 4)));
    }
  }
}

__device__ __forceinline__ unsigned long long block_sum(
    uint32_t v32, unsigned long long* scratch) {
  unsigned long long v = v32;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  unsigned long long total = 0;
  if (threadIdx.x == 0) {
    const int n_warps = blockDim.x >> 5;
    for (int i = 0; i < n_warps; ++i) total += scratch[i];
  }
  __syncthreads();
  return total;
}

// The threads a block may have and the blocks of that size that must fit an
// SM; together they cap the registers. The 16-byte frames-only variant is
// fastest at 64 registers or fewer (five blocks of 192 threads on an SM; left
// alone ptxas takes about 80 and the luma batch runs a tenth slower); the
// variants with cost sums need about 100 and slow down when squeezed below;
// the one that does everything (frames, costs, erase) spills at 128, so its
// blocks are held to 192 threads and it gets 168; the byte-load variants
// would spill at 128 too and are left alone. The 16-byte frames-only variant
// that keeps the bottom field gets 85 (four blocks of 192 threads), and the
// 16-byte frames + erase variant (no path launches it) is left alone: since
// the kernel took the parity as a template argument, ptxas for sm_90a
// spilled 4 bytes in it at 128 registers.
constexpr int kMaxThreadsAll = 192;  // frames + costs + erase
constexpr int max_threads(bool frames, bool costs, bool erase) {
  return frames && costs && erase ? kMaxThreadsAll : kMaxThreads;
}
constexpr int min_blocks(bool costs, bool erase, bool vec, bool top) {
  if (!vec || (erase && !costs)) return 1;
  return (!costs && !erase) ? (top ? 4 : 3) : 2;
}

template <bool FRAMES, bool COSTS, bool ERASE, bool VEC, bool TOP = true>
__global__ void __launch_bounds__(max_threads(FRAMES, COSTS, ERASE),
                                  min_blocks(COSTS, ERASE, VEC, TOP))
yadif_fieldmatch_kernel(const Params p) {
  static_assert(TOP || (FRAMES && !COSTS && !ERASE),
                "the bottom field is kept in the frames-only mode alone");
  int tile = blockIdx.x;
  int f = blockIdx.y;
  bool tile_meets_box = false;
  if (ERASE) {
    // one-dimensional grid, the blocks that meet the box first
    const int id = blockIdx.x;
    const int heavy = p.box_tiles * p.batch;
    tile_meets_box = id < heavy;
    if (tile_meets_box) {
      f = id / p.box_tiles;
      tile = p.box_tile0 + id - f * p.box_tiles;
    } else {
      const int light = p.n_tiles - p.box_tiles;
      f = (id - heavy) / light;
      tile = id - heavy - f * light;
      if (tile >= p.box_tile0) tile += p.box_tiles;
    }
  }
  const int fh = p.height / 2;
  const int fp = f > 0 ? f - 1 : 0;
  const int fn = f + 1 < p.batch ? f + 1 : p.batch - 1;
  uint32_t c_cur = 0, c_tp = 0, c_bt = 0;  // twice the thread's sums

  for (int chunk = 0; chunk < p.n_chunks; ++chunk) {
    const int item = chunk * blockDim.x + threadIdx.x;
    const int strip = item / p.n_words;
    const int c = item - strip * p.n_words;
    const int y_first = tile * p.tile_rows + strip * p.rows_per_strip;
    const int y_end =
        min(min(y_first + p.rows_per_strip, (tile + 1) * p.tile_rows), fh);
    const bool owns = strip < p.strips && y_first < y_end;

    // a top row as the cost sums take it: zero past the row's end (it is
    // loaded so unless frames are rebuilt from it)
    const int n_valid = p.width - c * kWord;
    auto for_costs = [n_valid](const Row& t) {
      Row z = t;
      if (FRAMES && n_valid < kWord) zero_past(z, n_valid);
      return z;
    };

    // t: cur top, b: cur bottom, pt/pb: prev top/bottom, nb: next bottom;
    // 0 = field row y, 1 = y + 1, m = y - 1. The three weaves whose combing
    // is summed: cur (t, b), tp (t, pb), bt (pt, b); up_* is the step from
    // the bottom row y - 1 to the top row y of each, kept from the row
    // before.
    Row t0 = {}, pt0 = {}, bm = {}, pbm = {};
    uint32_t t0l = 0, t0r = 0, t1l = 0, t1r = 0;
    Step up_cur = {}, up_tp = {}, up_bt = {};
    constexpr bool kTopZero = !FRAMES;
    if (owns) {
      const int r = 2 * y_first;
      t0 = load_raw<VEC, kTopZero>(p, f, kept_above<TOP>(y_first), c);
      if (COSTS) {
        pt0 = load_raw<VEC, true>(p, fp, r, c);
        if (y_first >= 1) {
          bm = load_raw<VEC, true>(p, f, r - 1, c);
          pbm = load_raw<VEC, true>(p, fp, r - 1, c);
        }
      }
      if (ERASE && tile_meets_box) {
        erase_word(p, t0, f, r, c, kTopZero);
        if (COSTS) {
          erase_word(p, pt0, fp, r, c, true);
          if (y_first >= 1) {
            erase_word(p, bm, f, r - 1, c, true);
            erase_word(p, pbm, fp, r - 1, c, true);
          }
        }
      }
      if (COSTS && y_first >= 1) {
        const Row t0c = for_costs(t0);
        up_cur = step(bm, t0c);
        up_tp = step(pbm, t0c);
        up_bt = step(bm, pt0);
      }
    }
    if (FRAMES) {
      aprons<VEC, ERASE>(p, t0, f, kept_above<TOP>(y_first), c, owns,
                         tile_meets_box, t0l, t0r);
    }

    for (int i = 0; i < p.rows_per_strip; ++i) {
      const int y = y_first + i;
      const int r = 2 * y;
      const bool act = owns && y < y_end;
      // else: below = the kept row itself (the top field's last row)
      const bool below = !TOP || y + 1 < fh;
      NewRows cur = {};
      if (act) {
        cur = load_rows<FRAMES, COSTS, ERASE, VEC, TOP>(p, f, fp, fn, y, c,
                                                        tile_meets_box);
        if (!below) cur.t1 = t0;
      }
      if (FRAMES) {
        aprons<VEC, ERASE>(p, cur.t1, f, TOP ? r + 2 : r + 1, c,
                           act && below, tile_meets_box, t1l, t1r);
        if (act && !below) {
          t1l = t0l;
          t1r = t0r;
        }
      }
      if (act) {
        if (FRAMES) {
          const uint32_t A[6] = {t0l, t0.w[0], t0.w[1], t0.w[2], t0.w[3], t0r};
          const uint32_t C[6] = {t1l,         cur.t1.w[0], cur.t1.w[1],
                                 cur.t1.w[2], cur.t1.w[3], t1r};
          // the kept row first, then the rebuilt one
          store_word(p, f, TOP ? r : r + 1, c, TOP ? t0 : cur.t1);
          store_word(p, f, TOP ? r + 1 : r, c,
                     rebuild(A, C, cur.pb0, cur.nb0));
        }
        if (COSTS) {
          const Row t0c = for_costs(t0);
          const Step mid_cur = step(t0c, cur.b0);
          const Step mid_tp = step(t0c, cur.pb0);
          const Step mid_bt = step(pt0, cur.b0);
          if (y >= 1) {  // even woven rows 2y, between bottom y-1 and y
            const uint32_t t_sq = dot(t0c.w, t0c.w);
            const uint32_t b_skip = dot(bm.w, cur.b0.w);
            comb(c_cur, up_cur, mid_cur, b_skip, t_sq);
            comb(c_tp, up_tp, mid_tp, dot(pbm.w, cur.pb0.w), t_sq);
            comb(c_bt, up_bt, mid_bt, b_skip, dot(pt0.w, pt0.w));
          }
          if (below) {  // odd woven rows 2y+1, between top y and y+1
            const Row t1c = for_costs(cur.t1);
            up_cur = step(cur.b0, t1c);
            up_tp = step(cur.pb0, t1c);
            up_bt = step(cur.b0, cur.pt1);
            const uint32_t b_sq = dot(cur.b0.w, cur.b0.w);
            const uint32_t t_skip = dot(t0c.w, t1c.w);
            comb(c_cur, mid_cur, up_cur, t_skip, b_sq);
            comb(c_tp, mid_tp, up_tp, t_skip, dot(cur.pb0.w, cur.pb0.w));
            comb(c_bt, mid_bt, up_bt, dot(pt0.w, cur.pt1.w), b_sq);
          }
        }
      }
      t0 = cur.t1;
      t0l = t1l;
      t0r = t1r;
      if (COSTS) {
        pt0 = cur.pt1;
        bm = cur.b0;
        pbm = cur.pb0;
      }
    }
  }

  if (COSTS) {
    __shared__ unsigned long long scratch[kMaxWarps];
    const unsigned long long s0 = block_sum(c_cur >> 1, scratch);
    const unsigned long long s1 = block_sum(c_tp >> 1, scratch);
    const unsigned long long s2 = block_sum(c_bt >> 1, scratch);
    if (threadIdx.x == 0) {
      long long* dst =
          p.partials + (static_cast<long long>(tile) * p.batch + f) * 3;
      dst[0] = static_cast<long long>(s0);
      dst[1] = static_cast<long long>(s1);
      dst[2] = static_cast<long long>(s2);
    }
  }
}

template <bool FRAMES, bool COSTS>
void launch(bool erase, bool vec, dim3 grid, int threads, cudaStream_t stream,
            const Params& p) {
  if constexpr (FRAMES && !COSTS) {
    if (p.bottom) {  // the host checked: no erase
      if (vec) {
        yadif_fieldmatch_kernel<true, false, false, true, false>
            <<<grid, threads, 0, stream>>>(p);
      } else {
        yadif_fieldmatch_kernel<true, false, false, false, false>
            <<<grid, threads, 0, stream>>>(p);
      }
      return;
    }
  }
  if (erase && vec) {
    yadif_fieldmatch_kernel<FRAMES, COSTS, true, true>
        <<<grid, threads, 0, stream>>>(p);
  } else if (erase) {
    yadif_fieldmatch_kernel<FRAMES, COSTS, true, false>
        <<<grid, threads, 0, stream>>>(p);
  } else if (vec) {
    yadif_fieldmatch_kernel<FRAMES, COSTS, false, true>
        <<<grid, threads, 0, stream>>>(p);
  } else {
    yadif_fieldmatch_kernel<FRAMES, COSTS, false, false>
        <<<grid, threads, 0, stream>>>(p);
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % kWord == 0;
}

}  // namespace

// src: [batch, height, width] uint8 with the given frame and row strides
// (elements); out: contiguous [batch, height, width] uint8 or null;
// partials: [ceil(height/2 / tile_rows), batch, 3] int64 or null.
// parity_top: 1 keeps the top field, 0 the bottom one (then partials and
// the erase box must be null).
// threads (a multiple of 32, at most 256, or 192 with out, partials and the
// erase all at once) and strips (row strips per block)
// are the block layout: strips * ceil(width/16) <= threads, or strips == 1
// and the threads loop over column chunks.
// a_box/b_box: [box_h, box_w] float32 and fades: [batch] float32, or all
// null for no erase. 16-byte accesses are used where src, its strides and
// out allow them. Returns cudaGetLastError() after the launch.
extern "C" int amt_yadif_fieldmatch(
    const void* src, long long frame_stride, long long row_stride, int batch,
    int height, int width, void* out, void* partials, int tile_rows,
    int strips, int threads, const void* a_box, const void* b_box,
    const void* fades, int box_y0, int box_x0, int box_h, int box_w,
    float maxv, int parity_top, void* stream) {
  if (!parity_top && (out == nullptr || partials != nullptr ||
                      a_box != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch < 1 || height < 2 || width < 1 || tile_rows < 1 || strips < 1 ||
      strips > tile_rows || threads < 32 ||
      threads > max_threads(out != nullptr, partials != nullptr,
                            a_box != nullptr) ||
      threads % 32 != 0 || (out == nullptr && partials == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.src = static_cast<const uint8_t*>(src);
  p.frame_stride = frame_stride;
  p.row_stride = row_stride;
  p.batch = batch;
  p.height = height;
  p.width = width;
  p.out = static_cast<uint8_t*>(out);
  p.partials = static_cast<long long*>(partials);
  p.tile_rows = tile_rows;
  p.strips = strips;
  p.rows_per_strip = (tile_rows + strips - 1) / strips;
  p.n_words = (width + kWord - 1) / kWord;
  p.n_chunks = (p.n_words * strips + threads - 1) / threads;
  if (p.n_chunks > 1 && strips != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(p.rows_per_strip) * p.n_chunks > kMaxRowWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.vec_out = out != nullptr && aligned16(out) && width % kWord == 0;
  p.a = static_cast<const float*>(a_box);
  p.b = static_cast<const float*>(b_box);
  p.fades = static_cast<const float*>(fades);
  p.y0 = box_y0;
  p.x0 = box_x0;
  p.box_h = box_h;
  p.box_w = box_w;
  p.maxv = maxv;
  p.bottom = parity_top ? 0 : 1;
  const bool vec = aligned16(src) && frame_stride % kWord == 0 &&
                   row_stride % kWord == 0;
  const bool erase = a_box != nullptr;
  const int fh = height / 2;
  p.n_tiles = (fh + tile_rows - 1) / tile_rows;
  p.box_tile0 = 0;
  p.box_tiles = 0;
  dim3 grid(p.n_tiles, batch);
  if (erase) {
    // a tile's rows (with its one-row halo) against the box rows
    for (int t = 0; t < p.n_tiles; ++t) {
      if (2 * t * tile_rows - 1 < box_y0 + box_h &&
          2 * (t + 1) * tile_rows + 1 > box_y0) {
        if (p.box_tiles++ == 0) p.box_tile0 = t;
      }
    }
    grid = dim3(static_cast<unsigned>(p.n_tiles) * batch, 1);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out != nullptr && partials != nullptr) {
    launch<true, true>(erase, vec, grid, threads, s, p);
  } else if (out != nullptr) {
    launch<true, false>(erase, vec, grid, threads, s, p);
  } else {
    launch<false, true>(erase, vec, grid, threads, s, p);
  }
  return static_cast<int>(cudaGetLastError());
}
