"""The family `yadif_post`: the plain reference of a configuration that
runs Amatsukaze's yadif profile with the post filters KDeblock,
KTemporalNR, KDeband and KEdgeLevel and a Lanczos3 resize
(nekopanda/Amatsukaze FilterSetting, Server/Misc.cs:1403-1441), its
compared numbers and the control that breaks its guarantee. The harness
finds this module by the configuration's "family"; it imports nothing of
the program and reads none of its decisions. Written from the filters'
definitions in plain PyTorch and NumPy.

- CM pass: the trims and CM zones are the layout's program and CM parts;
  the chosen logo is the logo file that holds the painted logo.
- Logo erase: Amatsukaze's Delogo (pb/delogo.py) on every source frame.
- The output file holds every frame of the recording, one output frame
  per source frame (yadif, 29.97p).
- yadif keeps the top field of each frame and rebuilds each bottom line:
  the spatial prediction is the mean of the kept lines above and below
  along the direction (0, +-1, +-2 columns, edges replicated) whose two
  samples differ least, taken in that order with a strict "less"; it is
  clamped into temporal mean +- half the temporal difference of the
  bottom fields of the frames before and after; rounded half up to 8
  bits. This is the port's yadif, which leaves out Yadifmod2's wider
  spatial check and its three-frame temporal difference.
- deblock (8-bit domain): every 8x8 block's DCT-II (orthonormal, a
  matrix product in float64, rounded to float32); each coefficient but
  the DC shrinks by the block's quantiser scale q when its magnitude is
  below 2q (to 0 below q); the inverse DCT likewise. q is the quantiser
  scale of the block's macroblock (the writer's per-row scales, not read
  from the stream); a 4:2:0 chroma block is one macroblock, a luma block a
  quarter of one. A plane whose height is not a multiple of 8 is extended
  by its last row first, and cut back after.
- Then the 14-bit domain (x 64): temporal NR (radius 2, threshold 64),
  deband (sample 2, range 15, threshold 96), edge level (strength 10,
  thresholds 128 and 2048), then back (/ 64).
- Lanczos3 (jax.image.resize's weights) to the configured size, chroma to
  half of it; rounded half up to 8 bits.

Where the port's definition departs from Amatsukaze's KFilters, the
reference follows the port's, and takes the batches of the output pass as
a stated input (`batches`): chunks of 32 frames, the first one a head
ramp of 8, each padded to 32 with repeats of its last frame; yadif reads
the frame before the chunk and the one after it, where they exist, else
the chunk's own end frames; padding slots deblock with the quantiser
scales of the frames that follow the chunk's last one. The departures:

- temporal NR reads its neighbours within the 32 slots of the chunk: slot
  i adds slot i+d where i-d lies inside the chunk and slot i-d where i+d
  does, both taken round the chunk's end (so the first slot reads the
  last two), each when it differs from slot i by less than the threshold,
  in the order +1, -1, +2, -2; the sum over the count. KTemporalNR reads
  the whole clip;
- deband draws from threefry2x32 (Salmon et al., SC'11) as JAX derives its
  keys: the frame's key is fold_in(PRNGKey(0), its slot in the chunk);
  step s splits it in two, the second half drawing each pixel's candidate
  randint(0, 8) and the first half keyed to the next step; the 8
  candidate offsets of step s are randint(-15, 16) pairs drawn from
  fold_in(PRNGKey(0 ^ 0x9E3779B9), s). Each pixel averages with both
  pixels at +-its offset (edges replicated) when both lie within the
  threshold of it: the pixel, then each step's pair summed, over the count.
  KDeband keys by the frame number;
- edge level: where the gradient |right - left| + |down - up| lies
  strictly between the thresholds, c - (mean of the 4 neighbours - c) x
  strength / 16 (rounded once), clamped into [min(neighbours, c),
  max(neighbours, c)].

The reference computes each sampled output frame from the frames of its
own chunk alone, on the harness's device, in the precision `dtype` (the
control runs it in bfloat16; deblock's DCT then in bfloat16 too).

Numbers (the worst over the window's recordings):
  cm_wrong          recordings whose CM pass gave other trims, CM zones or
                    logo than the layout's (cells whose traffic gives logos)
  count_wrong       recordings whose encoder got another number of frames
  samples_missing   sampled frames that the encoder did not get
  recordings_differ recordings whose encoder got frames other than the
                    first recording's, by their digests
  outside_gap       widest gap between a sampled frame and the reference's
                    off the logo box, grown by the chain's reach: REACH
                    pixels of each plane, then every output pixel whose
                    resize window touches that
  far_share         share of those pixels off by more than one level: the
                    reference rounds its DCT and its resize sums in another
                    order than the program, so a float step can tip a
                    threshold test or a rounding at a few pixels
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pb import compare, delogo
from pb.roofline_post import chain_of

BATCH = 32
HEAD_RAMP = 8
DEPTH_SCALE = 64.0  # 8 bits to the 14-bit domain
DEBLOCK_STRENGTH = 1.0
NR_RADIUS, NR_THRESHOLD = 2, 64.0
DEBAND_SEED, DEBAND_SAMPLE, DEBAND_RANGE, DEBAND_THRESHOLD = 0, 2, 15, 96.0
DEBAND_CANDIDATES = 8
DEBAND_OFFSET_SALT = 0x9E3779B9
EDGE_STRENGTH, EDGE_LOW, EDGE_HIGH = 10.0, 128.0, 2048.0
LANCZOS_RADIUS = 3.0
# plane pixels next to the logo box that the chain reads from it: yadif 2
# (columns), deblock 7 (a block), deband 15, edge level 1
REACH = 25
CHROMA = (1, 2, 2)  # subsampling of Y, U, V

# -- threefry2x32-20 and JAX's derivations ------------------------------------

M32 = 0xFFFFFFFF
ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
KS_PARITY = 0x1BD11BDA


def threefry2x32(key, ctr):
    """Threefry-2x32 with 20 rounds (Salmon, Moraes, Dror, Shaw, SC'11;
    Random123's threefry2x32_20): the key schedule (k0, k1, k0 ^ k1 ^
    0x1BD11BDA) added before the first round and after every fourth, with
    the injection count added to the second word. key: (k0, k1); ctr: (x0,
    x1); uint32 values as int64 tensors or ints, broadcast together."""
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) & M32 for k in key)
    x0, x1 = (torch.as_tensor(x, dtype=torch.int64) & M32 for x in ctr)
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for r in range(20):
        rot = ROTATIONS[r % 8]
        x0 = (x0 + x1) & M32
        x1 = ((x1 << rot) | (x1 >> (32 - rot))) & M32
        x1 = x1 ^ x0
        if r % 4 == 3:
            s = r // 4 + 1
            x0 = (x0 + ks[s % 3]) & M32
            x1 = (x1 + ks[(s + 1) % 3] + s) & M32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey of a 32-bit seed: (0, seed)."""
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in: the hash of the counter (0, data) under each
    key [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32((keys[..., 0], keys[..., 1]),
                          (torch.zeros_like(data), data))
    return torch.stack([y0, y1], dim=-1)


def split2(keys: torch.Tensor) -> tuple:
    """jax.random.split(key) of keys [..., 2]: the hashes of the counters
    (0, 0) and (0, 1)."""
    return (fold_in(keys, torch.zeros(keys.shape[:-1], dtype=torch.int64,
                                      device=keys.device)),
            fold_in(keys, torch.ones(keys.shape[:-1], dtype=torch.int64,
                                     device=keys.device)))


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """jax.random.bits, 32 bits, of keys [K, 2] -> [K, *shape]: element
    i (row-major) is the xor of the two words of the hash of the counter
    (i >> 32, i mod 2^32)."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32((keys[:, 0, None], keys[:, 1, None]),
                          (i >> 32, i & M32))
    return (y0 ^ y1).reshape(len(keys), *shape)


def randint(keys: torch.Tensor, shape, lo: int, hi: int) -> torch.Tensor:
    """jax.random.randint(key, shape, lo, hi) (int32) of keys [K, 2]:
    from the two halves of split(key), (hi_bits mod span) x (2^32 mod span)
    + (lo_bits mod span), in 32 bits, mod span, plus lo."""
    span = hi - lo
    mult = ((2 ** 16 % span) ** 2) % span
    k_hi, k_lo = split2(keys)
    high = random_bits(k_hi, shape) % span
    low = random_bits(k_lo, shape) % span
    return ((((high * mult) & M32) + low) & M32) % span + lo


# -- the chain ----------------------------------------------------------------

def batches(n: int, batch: int = BATCH, ramp: int = HEAD_RAMP) -> list:
    """(first source frame, real frames) of each chunk of the output pass
    over n frames: a head ramp of `ramp` frames where more follow, then
    `batch` at a time, the rest last."""
    out, start = [], 0
    if n > ramp:
        out.append((0, ramp))
        start = ramp
    while n - start > batch:
        out.append((start, batch))
        start += batch
    if n > start:
        out.append((start, n - start))
    return out


def dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II, float64: D[k, n] = c_k cos(pi (2n +
    1) k / 16), c_0 = sqrt(1/8), c_k = sqrt(2/8)."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    d = np.cos(np.pi * (2 * n + 1) * k / 16.0) * np.sqrt(2.0 / 8.0)
    d[0] = np.sqrt(1.0 / 8.0)
    return d


def lanczos3_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights of jax.image.resize's lanczos3
    (antialiased: the kernel stretched by the inverse scale when
    downscaling), in float32 as it computes them: sample (o + 0.5) / scale -
    0.5, sin(pi x) sin(pi x / 3) 3 / (pi x)^2 (1 near 0, 0 beyond 3), each
    column over its sum, columns outside [-0.5, in - 0.5] zero."""
    f32 = np.float32
    inv = f32(1.0) / f32(out_size / in_size)
    kscale = max(inv, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kscale
    with np.errstate(invalid="ignore", divide="ignore"):
        y = f32(LANCZOS_RADIUS) * np.sin(f32(np.pi) * x) \
            * np.sin(f32(np.pi) * x / f32(LANCZOS_RADIUS))
        kern = np.where(x > f32(1e-3),
                        y / np.where(x != 0, f32(np.pi ** 2) * x * x, f32(1)),
                        f32(1.0))
    kern = np.where(x > f32(LANCZOS_RADIUS), f32(0.0), kern).astype(f32)
    total = kern.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0) * np.finfo(f32).eps,
                 kern / np.where(total != 0, total, f32(1)), f32(0))
    keep = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(keep[None, :], w, f32(0)).astype(f32)


def replicate(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    return x.index_select(dim, idx.clamp(0, x.shape[dim] - 1))


def yadif(prev, cur, nxt, dtype) -> torch.Tensor:
    """The output frames [m, H, W] uint8 of source frames prev, cur, nxt
    ([m, H, W] uint8): cur's top field kept, each bottom line rebuilt
    (module docstring)."""
    p, c, n = (t.to(dtype) for t in (prev, cur, nxt))
    keep = c[:, 0::2]
    rows = torch.arange(keep.shape[1], device=c.device)
    above, below = keep, replicate(keep, rows + 1, 1)
    cols = torch.arange(c.shape[2], device=c.device)
    half = torch.tensor(0.5, dtype=dtype, device=c.device)
    best = (above + below) * half
    score = (above - below).abs()
    for d in (1, 2):
        for sgn in (1, -1):
            a = replicate(above, cols + sgn * d, 2)
            b = replicate(below, cols - sgn * d, 2)
            s = (a - b).abs()
            better = s < score
            best = torch.where(better, (a + b) * half, best)
            score = torch.where(better, s, score)
    tp, tn = p[:, 1::2], n[:, 1::2]
    mean = (tp + tn) * half
    diff = (tp - tn).abs() * half
    bottom = torch.minimum(torch.maximum(best, mean - diff), mean + diff)
    out = c.clone()
    out[:, 1::2] = bottom
    return torch.floor(out + half).clamp(0, 255).to(torch.uint8)


def deblock(x: torch.Tensor, qp: torch.Tensor, per_mb: int,
            dtype) -> torch.Tensor:
    """x [m, H, W] (8-bit domain) with qp [m, mb_h, mb_w]: the soft
    threshold of each 8x8 block's DCT coefficients (module docstring).
    per_mb: 8x8 blocks along each side of a macroblock (2 luma, 1
    chroma)."""
    m, h, w = x.shape
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    rows = torch.arange(hp, device=x.device)
    cols = torch.arange(wp, device=x.device)
    xp = replicate(replicate(x, rows, 1), cols, 2)
    wide = torch.float64 if dtype == torch.float32 else dtype
    d = torch.from_numpy(dct_matrix()).to(x.device, wide)
    blocks = xp.reshape(m, hp // 8, 8, wp // 8, 8).transpose(2, 3)
    coef = (d @ blocks.to(wide) @ d.T).to(dtype)
    q = qp.repeat_interleave(per_mb, 1).repeat_interleave(per_mb, 2)
    t = (q[:, :hp // 8, :wp // 8] * DEBLOCK_STRENGTH).to(dtype)[..., None,
                                                                None]
    mag = coef.abs()
    shrunk = torch.sign(coef) * torch.clamp_min(mag - t, 0.0)
    soft = torch.where(mag < 2 * t, shrunk, coef)
    soft[..., 0, 0] = coef[..., 0, 0]
    out = (d.T @ soft.to(wide) @ d).to(dtype)
    return out.transpose(2, 3).reshape(m, hp, wp)[:, :h, :w]


def temporal_nr(slots: dict, i: int, dtype) -> torch.Tensor:
    """Slot i of the chunk [H, W] after temporal NR over its slots (slot
    -> [H, W]; module docstring)."""
    c = slots[i]
    acc = c
    cnt = torch.ones_like(c)
    thr = torch.tensor(NR_THRESHOLD, dtype=dtype, device=c.device)
    for d in range(1, NR_RADIUS + 1):
        for reads, inside in ((i + d, i - d), (i - d, i + d)):
            if not 0 <= inside < BATCH:
                continue
            nb = slots[reads % BATCH]
            ok = (nb - c).abs() < thr
            acc = acc + torch.where(ok, nb, torch.zeros_like(nb))
            cnt = cnt + ok.to(dtype)
    return acc / cnt


def deband_offsets(device) -> list:
    """The DEBAND_CANDIDATES (dy, dx) offsets of each sample step."""
    base = prng_key(DEBAND_SEED ^ DEBAND_OFFSET_SALT, device)
    out = []
    for s in range(DEBAND_SAMPLE):
        key = fold_in(base, s)[None]
        offs = randint(key, (DEBAND_CANDIDATES, 2), -DEBAND_RANGE,
                       DEBAND_RANGE + 1)[0]
        out.append([tuple(int(v) for v in o) for o in offs.tolist()])
    return out


def deband(x: torch.Tensor, slot: int, offsets: list, dtype) -> torch.Tensor:
    """One plane [H, W] (14-bit domain) of the frame in `slot` after
    deband (module docstring)."""
    h, w = x.shape
    key = fold_in(prng_key(DEBAND_SEED, x.device), slot)[None]
    rows = torch.arange(h, device=x.device)[:, None]
    cols = torch.arange(w, device=x.device)[None, :]
    thr = torch.tensor(DEBAND_THRESHOLD, dtype=dtype, device=x.device)
    acc = x
    cnt = torch.ones_like(x)
    for s in range(DEBAND_SAMPLE):
        key, ksel = split2(key)
        sel = randint(ksel, (h, w), 0, DEBAND_CANDIDATES)[0]
        offs = torch.tensor(offsets[s], dtype=torch.int64, device=x.device)
        dy, dx = offs[sel, 0], offs[sel, 1]

        def at(yy, xx):
            return x[yy.clamp(0, h - 1), xx.clamp(0, w - 1)]

        n1 = at(rows + dy, cols + dx)
        n2 = at(rows - dy, cols - dx)
        ok = ((n1 - x).abs() < thr) & ((n2 - x).abs() < thr)
        acc = acc + torch.where(ok, n1 + n2, torch.zeros_like(x))
        cnt = cnt + 2 * ok.to(dtype)
    return acc / cnt


def edge_level(x: torch.Tensor, dtype) -> torch.Tensor:
    """One plane [H, W] (14-bit domain) after edge level (module
    docstring)."""
    h, w = x.shape
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)
    up = replicate(x, rows - 1, 0)
    dn = replicate(x, rows + 1, 0)
    lf = replicate(x, cols - 1, 1)
    rt = replicate(x, cols + 1, 1)
    grad = (rt - lf).abs() + (dn - up).abs()
    lap = (up + dn + lf + rt) * 0.25 - x
    wide = torch.float64 if dtype == torch.float32 else dtype
    sharp = (x.to(wide) - lap.to(wide) * (EDGE_STRENGTH / 16.0)).to(dtype)
    lo = torch.minimum(torch.minimum(torch.minimum(up, dn),
                                     torch.minimum(lf, rt)), x)
    hi = torch.maximum(torch.maximum(torch.maximum(up, dn),
                                     torch.maximum(lf, rt)), x)
    fixed = torch.minimum(torch.maximum(sharp, lo), hi)
    return torch.where((grad > EDGE_LOW) & (grad < EDGE_HIGH), fixed, x)


def resize(x: torch.Tensor, out_h: int, out_w: int, dtype) -> torch.Tensor:
    """[m, H, W] -> [m, out_h, out_w]: Lanczos3 over H, then over W, as
    matrix products."""
    _, h, w = x.shape
    if h != out_h:
        wh = torch.from_numpy(lanczos3_weights(h, out_h)).to(x.device, dtype)
        x = wh.T @ x
    if w != out_w:
        ww = torch.from_numpy(lanczos3_weights(w, out_w)).to(x.device, dtype)
        x = x @ ww
    return x


def reference(config: dict, rec, truth: dict, geometry: dict, logo_planes,
              dtype=torch.float32, device="cpu"):
    """The Reference of one recording (`rec` the synth.Recording,
    `logo_planes` the painted logo's six window planes, None without a
    logo)."""
    return Reference(config, rec, truth, geometry, logo_planes, dtype, device)


class Reference:
    """The frames and decisions one recording of a configuration must
    give."""

    def __init__(self, config: dict, rec, truth: dict, geometry: dict,
                 lgd_planes=None, dtype=torch.float32, device="cpu",
                 workers: int = 8):
        self.rec, self.truth = rec, truth
        self.geometry, self.dtype, self.device = geometry, dtype, device
        self.workers = workers
        self.tokens, size = chain_of(config)
        self.out_size = size or (geometry["width"], geometry["height"])
        self.cm_pass = truth["logos_given"]
        self.ab = (delogo.logo_planes(lgd_planes, geometry)
                   if lgd_planes is not None else None)
        self.fade = delogo.fade_curve(truth) if self.ab is not None else None
        self.chunks = batches(truth["frames"])

    @property
    def num_out(self) -> int:
        return self.truth["frames"]

    def seams(self) -> list:
        """Output indices on either side of each edge between two parts of
        the layout (where the logo fades and the content changes)."""
        return [i for p in self.truth["parts"][1:]
                for i in (p["first"] - 1, p["first"])]

    def filter_result(self) -> dict:
        return dict(num_out=self.num_out)

    def off_box(self) -> list:
        """Per output plane, True off the logo box grown by REACH plane
        pixels and by the resize's window (all True without a logo)."""
        ow, oh = self.out_size
        g = self.geometry
        out = []
        for s in CHROMA:
            shape = (oh // s, ow // s)
            if self.ab is None:
                out.append(np.ones(shape, bool))
                continue
            lx, ly, lw, lh = g["logo_box"]
            h, w = g["height"] // s, g["width"] // s
            r0, r1 = max(0, ly // s - REACH), min(h, -(-(ly + lh) // s) + REACH)
            c0, c1 = max(0, lx // s - REACH), min(w, -(-(lx + lw) // s) + REACH)
            rows_w = (lanczos3_weights(h, shape[0]) if h != shape[0]
                      else np.eye(h, dtype=np.float32))
            cols_w = (lanczos3_weights(w, shape[1]) if w != shape[1]
                      else np.eye(w, dtype=np.float32))
            rows = (rows_w[r0:r1] != 0).any(axis=0)
            cols = (cols_w[c0:c1] != 0).any(axis=0)
            out.append(~(rows[:, None] & cols[None, :]))
        return out

    def erased(self, planes, k: int) -> tuple:
        if self.ab is None:
            return planes
        return delogo.erase(planes, self.ab, float(self.fade[k]), self.dtype,
                            "cpu")

    def frames(self, indices: list, with_deblock: bool = True) -> dict:
        """Output frames at the given output indices: for each, the list of
        (frame, how it was made) the configuration allows there (one:
        ("chain", index)). with_deblock=False leaves deblock out of the
        chain (the guarantee control). Float32 matrix products run in
        float32, not TF32."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._frames(indices, with_deblock)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags

    def _frames(self, indices: list, with_deblock: bool) -> dict:
        starts = [c[0] for c in self.chunks]
        want: dict[int, list] = {}
        for i in indices:
            c = int(np.searchsorted(starts, i, side="right")) - 1
            want.setdefault(c, []).append(i)
        plans = {c: self._slots(c, want[c]) for c in want}
        need = sorted({k for slots, _ in plans.values()
                       for trio in slots.values() for k in trio})
        with ThreadPoolExecutor(self.workers) as pool:
            src = dict(zip(need, pool.map(
                lambda k: self.erased(self.rec.reconstruct(k), k), need)))
        out = {}
        offsets = deband_offsets(self.device)
        for c, (slots, qp_of) in plans.items():
            start, _ = self.chunks[c]
            got = self._chunk(slots, qp_of, src, offsets,
                              [i - start for i in want[c]], with_deblock)
            for i in want[c]:
                out[i] = [(got[i - start], ("chain", i))]
        return out

    def _slots(self, c: int, indices: list) -> tuple:
        """The slots of chunk c that its sampled frames read ({slot: (source
        frame before, of, after it)}) and each slot's frame for its
        quantiser scales."""
        n = self.num_out
        start, real = self.chunks[c]

        def src(j):
            return start + min(j, real - 1)

        def ext(p):  # the chunk with the frames around it
            if p == 0:
                return start - 1 if start > 0 else src(0)
            if p == BATCH + 1:
                return start + real if start + real < n else src(BATCH - 1)
            return src(p - 1)

        need = set()
        for i in indices:
            j = i - start
            need |= {(j + d) % BATCH for d in range(-NR_RADIUS,
                                                   NR_RADIUS + 1)}
        slots = {j: (ext(j), ext(j + 1), ext(j + 2)) for j in sorted(need)}
        qp_of = {j: min(start + j, n - 1) for j in slots}
        return slots, qp_of

    def _chunk(self, slots: dict, qp_of: dict, src: dict, offsets: list,
               sampled: list, with_deblock: bool) -> dict:
        """The output planes of the sampled slots of one chunk."""
        dev, dt = self.device, self.dtype
        order = sorted(slots)
        ow, oh = self.out_size
        planes = {j: [] for j in sampled}
        for p, s in enumerate(CHROMA):
            def stack(pos):
                return torch.from_numpy(np.stack(
                    [src[slots[j][pos]][p] for j in order])).to(dev)

            x = yadif(stack(0), stack(1), stack(2), dt).to(dt)
            if with_deblock and "deblock" in self.tokens:
                qp = torch.from_numpy(np.stack(
                    [np.repeat(self.rec.row_qs[qp_of[j]][:, None],
                               -(-self.rec.w // 16), axis=1)
                     for j in order]).astype(np.float32)).to(dev)
                x = deblock(x, qp, 2 if p == 0 else 1, dt)
            x = x * DEPTH_SCALE
            by_slot = dict(zip(order, x))
            outs = []
            for j in sampled:
                y = by_slot[j]
                if "nr" in self.tokens:
                    y = temporal_nr(by_slot, j, dt)
                if "deband" in self.tokens:
                    y = deband(y, j, offsets, dt)
                if "edge" in self.tokens:
                    y = edge_level(y, dt)
                outs.append(y * (1.0 / DEPTH_SCALE))
            y = resize(torch.stack(outs), oh // s, ow // s, dt)
            q = torch.floor(y + 0.5).clamp(0, 255).to(torch.uint8).cpu()
            for j, plane in zip(sampled, q.numpy()):
                planes[j].append(plane)
        return {j: tuple(v) for j, v in planes.items()}


def numbers(ref, expected: dict, served: list, cm_results: list,
            filter_results: list) -> dict:
    """The compared numbers of one run. expected: output index -> the
    (frame, how it was made) pairs the reference allows there; served: per
    recording, the encoder's file as loaded (None where it wrote none);
    cm_results: per recording, what the CM pass decided (None where it did
    not run)."""
    truth = ref.truth
    out = dict(count_wrong=0, samples_missing=0, outside_gap=0,
               far_share=0.0,
               recordings_differ=compare.recordings_differ(served))
    if ref.cm_pass:
        want_logo = truth["painted_logo_file"]
        out["cm_wrong"] = sum(
            1 for c in cm_results
            if c is None or c["trims"] != truth["trims"]
            or c["cm_zones"] != truth["cm_zones"]
            or c["logo_file"] != want_logo)
    off = ref.off_box()
    for enc in served:
        if enc is None or enc["n_frames"] != ref.num_out:
            out["count_wrong"] += 1
        if enc is None:
            out["samples_missing"] += len(expected)
            continue
        far = total = 0
        for k, allowed in expected.items():
            got = enc["frames"].get(k)
            want = allowed[0][0]
            if got is None or any(g.shape != w.shape
                                  for g, w in zip(got, want)):
                out["samples_missing"] += 1
                continue
            out["outside_gap"] = max(out["outside_gap"],
                                     compare.outside_gap(got, want, off))
            for g, w, m in zip(got, want, off):
                gap = np.abs(g.astype(np.int32) - w.astype(np.int32))[m]
                far += int((gap > 1).sum())
                total += gap.size
        if total:
            out["far_share"] = max(out["far_share"], far / total)
    return out


def guarantee_control(ref, keep: list) -> tuple:
    """What a program that breaks the profile's guarantee hands the
    encoder: the chain run without deblock (what a program without the
    stream's QP maps gives). (frames at the kept output indices, output
    count, filter results)."""
    frames = {i: v[0][0] for i, v in
              ref.frames(keep, with_deblock=False).items()}
    return frames, ref.num_out, [ref.filter_result()]
