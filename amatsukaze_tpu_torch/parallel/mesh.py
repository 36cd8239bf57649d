"""Frame-axis sharding of one file's filter pass over several devices.

Counterpart of amatsukaze_tpu/parallel/mesh.py. The JAX package shards the
frame axis over a `jax.sharding.Mesh` from one controller: the host decides
the KFM cycles and the VFR plan, ships each shard its slab, and neighbours
exchange one halo frame (`ppermute`). The port keeps that design: one
process drives the N devices of a `Mesh`, each shard's work goes on its
device's current stream, and a halo frame is one device-to-device copy. (A
process per device over NCCL would split the host state that decides the
cycles and the plan.)

A halo copy is `dst.copy_(src)` between two devices: ATen runs it on the
source device's current stream with events both ways
(aten/src/ATen/native/cuda/Copy.cu), so it is ordered after the sender's
upload or kernel and before the receiver's next work. A device may appear
more than once in a mesh: its shards are logical shards on one device,
whose work and copies share its one stream. That is how one card (or the
CPU, in the tests) runs n > 1 shards.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import deint as deint_ops
from ..ops import denoise as dn_ops
from ..ops import logo as logo_ops
from ..ops import logo_eval


class Mesh:
    """An ordered list of devices along one axis (the frame axis)."""

    def __init__(self, devices, axis: str = "data"):
        self.devices = [_canonical(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def _canonical(dev: torch.device) -> torch.device:
    """cuda -> cuda:<current index>, so that equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    """A mesh over `devices` (torch devices or their names; one may repeat),
    by default over every visible CUDA device. Raises without one."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass "
                               "devices=['cpu'] * n for CPU shards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices, axis)


def halo_buffers(mesh: Mesh, host: np.ndarray, front: bool = True,
                 back: bool = True) -> list[torch.Tensor]:
    """Per-shard buffers [front + B/n + back, ...] on the shards' devices
    with the contiguous shards of `host` [B, ...] (B divisible by the mesh
    size) uploaded into their interiors; the halo slots are left for
    exchange_halo."""
    n = mesh.size
    if len(host) % n:
        raise ValueError(f"{len(host)} frames do not split over {n} shards")
    per = len(host) // n
    src = torch.from_numpy(np.ascontiguousarray(host))
    bufs = []
    for k, dev in enumerate(mesh.devices):
        buf = torch.empty((int(front) + per + int(back),) + src.shape[1:],
                          dtype=src.dtype, device=dev)
        buf[int(front):int(front) + per].copy_(src[k * per:(k + 1) * per],
                                               non_blocking=True)
        bufs.append(buf)
    return bufs


def exchange_halo(bufs: list[torch.Tensor], first=None, last=None,
                  back: bool = True) -> None:
    """Fill the halo slots of per-shard buffers in place: slot 0 of shard k
    receives shard k-1's last frame and (with `back`) its last slot shard
    k+1's first frame, each a copy from the neighbour's device. At the mesh
    ends the slots take `first` / `last` where given (the sequence's true
    neighbours), else the shard's own edge frame (the clamp of the JAX
    package's mesh.py:37-56)."""
    n = len(bufs)
    last_inner = -2 if back else -1
    for k, buf in enumerate(bufs):
        if k > 0:
            buf[0].copy_(bufs[k - 1][last_inner], non_blocking=True)
        elif first is not None:
            buf[0].copy_(torch.as_tensor(first), non_blocking=True)
        else:
            buf[0].copy_(buf[1])
        if not back:
            continue
        if k < n - 1:
            buf[-1].copy_(bufs[k + 1][1], non_blocking=True)
        elif last is not None:
            buf[-1].copy_(torch.as_tensor(last), non_blocking=True)
        else:
            buf[-1].copy_(buf[-2])


def gather(mesh: Mesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """The shards' outputs, in order, concatenated on the mesh's first
    device."""
    dev = mesh.devices[0]
    return torch.cat([p.to(dev, non_blocking=True) for p in parts])


def shard_batch(mesh: Mesh, arr) -> list[torch.Tensor]:
    """A host array [B, ...] (B divisible by the mesh size) as contiguous
    shards, one on each device of the mesh."""
    return halo_buffers(mesh, np.asarray(arr), front=False, back=False)


def params_on(params: logo_ops.LogoEvalParams,
              device: torch.device) -> logo_ops.LogoEvalParams:
    """The logo's evaluation operands on `device`."""
    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name).to(device)
        for f in dataclasses.fields(params)
        if torch.is_tensor(getattr(params, f.name))})


def sharded_pipeline_step(mesh: Mesh, logo_params: logo_ops.LogoEvalParams):
    """The multi-device pipeline step (mesh.py:59-109): step(frames [B, H,
    W] float32, fades [B]) with B divisible by the mesh size. Per shard:
    the logo scores of the deinterlaced logo window at fades 0 and 1 (K3's
    float32 entry), the erase at the given fades, yadif with the halo,
    field-match costs with the halo, and the share of frames whose score at
    fade 0 exceeds 0.2, averaged over the shards as `pmean` does. Returns
    (filtered [B, H, W], scores [B, 2], costs [B, 3], presence), each on the
    mesh's first device."""
    lh, lw = logo_params.a_y.shape
    per_dev = {dev: params_on(logo_params, dev) for dev in set(mesh.devices)}

    def step(frames, fades):
        fades = torch.as_tensor(np.asarray(fades, np.float32))
        per = len(frames) // mesh.size
        bufs = halo_buffers(mesh, np.asarray(frames, np.float32))
        scores = []
        for k, (buf, dev) in enumerate(zip(bufs, mesh.devices)):
            params = per_dev[dev]
            window = buf[1:-1, :lh, :lw]
            scores.append(logo_eval.evaluate_logo(
                params, logo_ops.batched_deint_y(window), 255.0,
                torch.tensor([0.0, 1.0], device=dev)))
            f = fades[k * per:(k + 1) * per].to(dev)
            window.copy_(logo_ops.batched_delogo(window, params.a_y,
                                                 params.b_y, 255.0, f))
        exchange_halo(bufs)
        filtered, costs, presence = [], [], []
        for buf, s in zip(bufs, scores):
            filtered.append(deint_ops.yadif_deinterlace(
                buf[:-2], buf[1:-1], buf[2:], True))
            costs.append(deint_ops.field_match_costs(buf[:-1])[1:])
            presence.append((s[:, 0] > 0.2).float().mean())
        return (gather(mesh, filtered), gather(mesh, scores),
                gather(mesh, costs), gather(mesh, [p[None] for p in presence])
                .mean())

    return step


def sharded_hbd_chain(mesh: Mesh):
    """The sharded high-bit-depth chain (mesh.py:112-132): step(frames
    [B, H, W] 8-bit, seed) -> [B, H, W] 10-bit on the mesh's first device.
    Per shard: to 14 bits, temporal NR (radius 1) with the halo, deband
    keyed by the global frame index (so the result equals the single-device
    call), to 10 bits."""

    def step(frames_8bit, seed: int):
        per = len(frames_8bit) // mesh.size
        bufs = [dn_ops.to_14bit(b) for b in
                halo_buffers(mesh, np.asarray(frames_8bit))]
        exchange_halo(bufs)
        out = []
        for k, buf in enumerate(bufs):
            x = dn_ops.temporal_nr(buf, radius=1)[1:-1]
            x = dn_ops.deband(x, seed, frame_offset=k * per)
            out.append(dn_ops.to_10bit(x))
        return gather(mesh, out)

    return step
