"""The FilterGraph device paths sharded over a mesh along the frame axis.

Counterpart of amatsukaze_tpu/parallel/sharded_filter.py (the `--devices
N` path, FilterGraph.set_mesh). Each method takes a host batch, runs one
shard per device of the mesh on that device (parallel/mesh.py: one
process, halo frames copied between neighbours' devices) and returns the
shards' outputs brought together on the mesh's first device in global
order, padded as the JAX package pads them:

- field_match_costs: K2 (the yadif_fieldmatch kernel, costs only) over each
  shard with one halo slot in front, the left neighbour's last frame (the
  batch's first frame on shard 0); the batch is padded to the mesh size
  with its last frame;
- deint: yadif / yadif60 / qtgmc with the true temporal neighbours at the
  batch ends and the neighbours' edge frames between shards; the batch is
  padded with the lookahead frame. Where the caller rounds straight to
  uint8, yadif and yadif60 run K1 (both parities for yadif60) and return
  uint8; otherwise the plain float yadif, as the JAX mesh path feeds its
  post chain and resize; qtgmc is the plain motion-adaptive bob;
- kfm_synth: the host-directed VFR synthesis: the output entries split
  into n contiguous runs padded to n * ceil(n_e / n) with the last entry,
  each shard shipped the contiguous source slab [min_src - 1, max_src] its
  run reads, the gather (weave / pulldown repair / bob) done there.

The post chain, the resize and the rounding then run on the first device
over the whole batch, as XLA runs them over the global sharded array:
temporal NR rolls around the batch and deband keys by the index in the
batch, so a per-shard chain would need far neighbours.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.kfm import VFRPlan
from ..ops import deint as deint_ops
from ..ops import fused_filter
from .mesh import Mesh, exchange_halo, gather, halo_buffers


def _pad_to(arr: np.ndarray, n: int, fill: np.ndarray) -> np.ndarray:
    """arr [B, ...] padded to a multiple of n rows with copies of `fill`."""
    pad = (-len(arr)) % n
    if not pad:
        return arr
    return np.concatenate([arr, np.repeat(fill[None], pad, axis=0)])


class ShardedFilterBackend:
    """Mesh-sharded FilterGraph device paths. Inputs are host arrays (the
    decoder's batches), uint8 or 10-bit samples as int16; outputs are
    tensors on the mesh's first device."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = mesh.size

    def put_batch(self, frames: np.ndarray) -> torch.Tensor:
        """The batch [B, ...] through the shards (padded to the mesh size
        with its last frame) and back together: mode none's path into the
        post chain."""
        b = len(frames)
        parts = halo_buffers(self.mesh, _pad_to(frames, self.n, frames[-1]),
                             front=False, back=False)
        return gather(self.mesh, parts)[:b]

    def field_match_costs(self, arr: np.ndarray) -> torch.Tensor:
        """Field-match costs [B, 3] float32 of a uint8 batch [B, H, W]: the
        rows of fused_filter.yadif_fieldmatch(arr, costs only)."""
        b = len(arr)
        bufs = halo_buffers(self.mesh, _pad_to(arr, self.n, arr[-1]),
                            back=False)
        exchange_halo(bufs, back=False)
        costs = [fused_filter.yadif_fieldmatch(
            buf, write_frames=False, with_costs=True)[1][1:] for buf in bufs]
        return gather(self.mesh, costs)[:b]

    def deint(self, mode: str, frames: np.ndarray, prev_frame, next_frame,
              rounded: bool = False) -> torch.Tensor:
        """yadif / yadif60 / qtgmc over a uint8 batch [B, H, W] with its
        temporal neighbours prev_frame / next_frame (None at the sequence
        ends: the edge frame itself). Returns [B, H, W] (yadif) or [2B, H,
        W] (both fields in order): uint8 from K1 where `rounded` and the
        mode is yadif or yadif60, else float32."""
        b = len(frames)
        first = frames[0] if prev_frame is None else prev_frame
        last = frames[-1] if next_frame is None else next_frame
        bufs = halo_buffers(self.mesh, _pad_to(frames, self.n, last))
        exchange_halo(bufs, first=first, last=last)
        out = []
        for buf in bufs:
            if rounded and mode in ("yadif", "yadif60"):
                # K1's own batch-edge rule repeats the halo slots, which
                # only the dropped rows see
                o = fused_filter.yadif_fieldmatch(buf)[0][1:-1]
                if mode == "yadif60":
                    bottom = fused_filter.yadif_fieldmatch(
                        buf, parity_top=False)[0][1:-1]
                    o = torch.stack([o, bottom], dim=1).flatten(0, 1)
            else:
                x = buf.float()
                prev, cur, nxt = x[:-2], x[1:-1], x[2:]
                if mode == "qtgmc":
                    o = deint_ops.motion_adaptive_bob(prev, cur, nxt, True)
                elif mode == "yadif":
                    o = deint_ops.yadif_deinterlace(prev, cur, nxt, True)
                else:  # yadif60: one yadif per field, top first
                    o = torch.stack(
                        [deint_ops.yadif_deinterlace(prev, cur, nxt, True),
                         deint_ops.yadif_deinterlace(prev, cur, nxt, False)],
                        dim=1).flatten(0, 1)
            out.append(o)
        factor = 1 if mode == "yadif" else 2
        return gather(self.mesh, out)[:b * factor]

    def kfm_synth(self, frames: np.ndarray, prev_frame,
                  entries: list) -> tuple[torch.Tensor, int]:
        """VFR output synthesis of one batch: frames [B, H, W] uint8 source
        frames, prev_frame the source frame before them (None at the head),
        entries (local source index, field op) in output order. Returns
        (float32 [n * E, H, W] in output order, the first n_e real),
        n_e = len(entries), E = ceil(n_e / n)."""
        from ..models.filter_graph import bob_field, merge_prev_weave

        n_e = len(entries)
        if not n_e:
            raise ValueError("kfm_synth needs at least one entry")
        e_per = -(-n_e // self.n)
        padded = entries + [entries[-1]] * (self.n * e_per - n_e)
        # ext[0] is the frame before the batch (frame 0 itself at the
        # head), so every source s has its previous frame at ext[s]
        pf = frames[0] if prev_frame is None else prev_frame
        ext = np.concatenate([np.asarray(pf)[None], frames])
        ops_used = {op for _, op in entries}
        out = []
        for k, dev in enumerate(self.mesh.devices):
            run = padded[k * e_per:(k + 1) * e_per]
            lo = min(s for s, _ in run)  # = min(s + 1) - 1 in ext
            hi = max(s for s, _ in run) + 1
            slab = torch.from_numpy(np.ascontiguousarray(ext[lo:hi + 1])).to(
                dev, non_blocking=True).float()
            prev = torch.cat([slab[:1], slab[:-1]])
            variants = {VFRPlan.WEAVE: slab}
            if VFRPlan.MERGE_PREV in ops_used:
                variants[VFRPlan.MERGE_PREV] = merge_prev_weave(slab, prev)
            if VFRPlan.BOB_T in ops_used:
                variants[VFRPlan.BOB_T] = bob_field(slab, top=True)
            if VFRPlan.BOB_B in ops_used:
                variants[VFRPlan.BOB_B] = bob_field(slab, top=False)
            idx = torch.tensor([s + 1 - lo for s, _ in run], device=dev)
            op_arr = np.asarray([op for _, op in run])
            o = variants[VFRPlan.WEAVE][idx]
            for op in ops_used - {VFRPlan.WEAVE}:
                m = torch.from_numpy(op_arr == op).to(dev)[:, None, None]
                o = torch.where(m, variants[op][idx], o)
            out.append(o)
        return gather(self.mesh, out), n_e
