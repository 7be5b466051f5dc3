"""Tile-row bands of the renders over several devices: each device renders
a contiguous band of macro-tile rows, and the gradient partials of the
bands are summed in band order.

The counterpart of the JAX package's parallel/sharded.py, whose
shard_map over a ("tiles",) mesh becomes an explicit loop over the bands:

  * mesh: a `TileMesh`, an ordered list of devices, one per band (a
    device may repeat: several bands on one card, or on the CPU), and an
    optional process group (parallel/distributed.py) across which every
    process renders its own bands;
  * the slot / record buffers and the cam vector are replicated: every
    band reads them on its own device; the K-cover buffer is pixel-banded
    (each band selects and keeps the cover records of its own pixels);
  * every band runs the single-device kernels on its rows, given the
    band's meta row [row_offset, starts slice] (`_band_metas`) or, for the
    K-cover step, its first pixel row row0_px;
  * the band outputs are gathered onto the mesh's first device in band
    order (across processes by all_gather of CPU copies), so every process
    holds the whole image;
  * one autograd function per render kind (`_BandRender` with the kind's
    band forward and backward) runs each band's hand-written backward and
    adds the band partials IN BAND ORDER on the first device: the 18-entry
    cam gradient for the fused paths, the record gradients for the
    general one. Never an all_reduce or an autograd accumulation, whose
    summation order is not fixed (so a run repeats bit for bit).

n_ty must be a multiple of the band count: the entry points pad the tile
grid with empty rows (their starts repeat the last one), as the JAX
package's wrappers do.
"""

from __future__ import annotations

import contextlib

import torch

from .._device import F32


class TileMesh:
    """The ("tiles",) mesh of the port: `devices` lists the devices of this
    process's bands in band order; `group` (optional) is a
    torch.distributed process group whose every rank owns as many bands,
    rank r's bands following rank r-1's. shape["tiles"] is the band count
    over all ranks."""

    def __init__(self, devices, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("TileMesh needs at least one device")
        self.group = group
        n_local = len(self.devices)
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
            counts = [torch.zeros((1,), dtype=torch.int64)
                      for _ in range(self.world)]
            dist.all_gather(counts, torch.tensor([n_local]), group=group)
            if any(int(c) != n_local for c in counts):
                raise ValueError(
                    "every rank of a TileMesh owns the same number of bands: "
                    f"{[int(c) for c in counts]}")
        self.band0 = self.rank * n_local
        self.shape = {"tiles": n_local * self.world}

    @property
    def device(self) -> torch.device:
        """The first local device: the gathered outputs and the summed
        gradients live here."""
        return self.devices[0]

    def local_bands(self):
        """(local index, global band index, device) of this process's
        bands, in band order."""
        return [(i, self.band0 + i, d) for i, d in enumerate(self.devices)]

    def gather(self, parts):
        """Stack the local bands' equal-shaped tensors with every other
        rank's, in global band order: (n_bands, *shape) on `device`."""
        local = torch.stack([p.to(self.device) for p in parts])
        if self.group is None:
            return local
        import torch.distributed as dist

        host = local.cpu()
        out = [torch.empty_like(host) for _ in range(self.world)]
        dist.all_gather(out, host, group=self.group)
        return torch.cat(out).to(self.device)

    def __repr__(self):
        return (f"TileMesh(bands={self.shape['tiles']}, devices="
                f"{[str(d) for d in self.devices]}, rank={self.rank}/"
                f"{self.world})")


def make_tile_mesh(n_devices: int | None = None, devices=None) -> TileMesh:
    """A TileMesh over `devices` (a list that may repeat a device: several
    bands on one card, or the CPU); without it, over the visible CUDA
    devices (the first n_devices). Raises when there is no CUDA device
    and no list: it never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_tile_mesh(): no CUDA device; pass devices=[...] "
                "(e.g. ['cpu'] * 4) to band the image on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return TileMesh(devices)


def _check_mesh(mesh, n_ty: int | None = None) -> int:
    """The band count; raises for what is not a TileMesh or a tile grid the
    bands do not divide."""
    if not isinstance(mesh, TileMesh):
        raise TypeError(f"mesh must be a TileMesh, got {type(mesh).__name__}")
    d = mesh.shape["tiles"]
    if n_ty is not None and n_ty % d != 0:
        raise ValueError(f"n_ty={n_ty} not divisible by mesh size {d}")
    return d


def _on(dev):
    """Make `dev` the current CUDA device (kernels launch on its stream)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _band_sum(parts):
    """Sum the (n_bands, ...) partials in band order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


class _BandRender(torch.autograd.Function):
    """Images of the bands, stacked row-wise, differentiable w.r.t. x (the
    cam vector or the record buffer, replicated to every band's device).
    band_fwd(i, b, dev, x) -> ((C, rows, wp) image rows, saved);
    band_bwd(i, b, dev, x, saved, cot (C, rows, wp)) -> the band's
    gradient of x. Returns the C images (n_bands * rows, wp)."""

    @staticmethod
    def forward(ctx, x, mesh, band_fwd, band_bwd):
        x = x.detach().contiguous()
        outs, saved, xs = [], [], []
        for i, b, dev in mesh.local_bands():
            with _on(dev):
                xd = x.to(dev)
                out, s = band_fwd(i, b, dev, xd)
            xs.append(xd)
            outs.append(out)
            saved.append(s)
        ctx.mesh, ctx.band_bwd, ctx.xs, ctx.saved = mesh, band_bwd, xs, saved
        img = mesh.gather(outs)  # (D, C, rows, wp)
        d, c, rows, wp = img.shape
        return tuple(img.transpose(0, 1).reshape(c, d * rows, wp).unbind(0))

    @staticmethod
    def backward(ctx, *cots):
        mesh = ctx.mesh
        # the cotangent of every output (autograd materializes unused
        # ones as zeros)
        cot = torch.stack([g.to(F32) for g in cots])
        rows = cot.shape[1] // mesh.shape["tiles"]
        parts = []
        for (i, b, dev), xd, s in zip(mesh.local_bands(), ctx.xs, ctx.saved):
            with _on(dev):
                band_cot = cot[:, b * rows:(b + 1) * rows].to(dev).contiguous()
                parts.append(ctx.band_bwd(i, b, dev, xd, s, band_cot))
        return _band_sum(mesh.gather(parts)), None, None, None


def _d_cam(d12):
    """The 18-entry cam gradient of 12 pose partials [dR(9), dt(3)]."""
    z = d12.new_zeros
    return torch.cat([z((4,)), d12[:12].reshape(12), z((2,))])


def _replicas(mesh, t):
    """`t` on each local band's device (one copy per distinct device)."""
    copies = {}
    return [copies.setdefault(dev, t.to(dev)) for _, _, dev in
            mesh.local_bands()]


def sharded_composite(
    packed_records,  # (16, M_pad) slot buffer, replicated
    tile_starts,  # (n_ty*n_tx + 1,) int32
    n_ty: int,
    n_tx: int,
    mesh: TileMesh,
):
    """Tile-row-banded ops.rasterize_tiles.composite_tiles: every band runs
    the general forward walk (K6a) on its tile rows; the backward (K6b)
    gives each band's (16, M_pad) record gradients, summed in band order.
    n_ty must be a multiple of the band count. Returns the same 5
    full-image tensors (n_ty*16, n_tx*128) on the mesh's first device."""
    from ..ops.rasterize_tiles import rasterize_bwd, rasterize_fwd

    d = _check_mesh(mesh, n_ty)
    rows_per = n_ty // d
    metas = _band_metas(tile_starts, d, rows_per * n_tx, rows_per)

    def band_fwd(i, b, dev, records):
        meta = metas[b].to(dev)
        out, cd = rasterize_fwd(records, meta, rows_per, n_tx)
        return out, (meta, out, cd)

    def band_bwd(i, b, dev, records, saved, cot):
        meta, out, cd = saved
        px_in = torch.cat([out, cot]).contiguous()
        return rasterize_bwd(records, meta, cd, px_in, rows_per, n_tx)

    return _BandRender.apply(packed_records, mesh, band_fwd, band_bwd)


def sharded_fused_render(
    slot3d,  # (8, M_pad) 3D slot buffer, replicated
    tile_starts,  # (n_ty*n_tx + 1,) int32
    cam,  # (18,) camera scalar vector (differentiable)
    n_ty: int,
    n_tx: int,
    mesh: TileMesh,
    near: float,
    far: float,
):
    """Tile-row-banded full-tile tracking render (ops/fused_tracking.py):
    every band runs K7a on its tile rows and K7b for its 12 pose partials,
    summed in band order. Returns (depth_acc, alpha) (n_ty*16, n_tx*128)
    on the mesh's first device."""
    from ..ops.fused_tracking import fused_bwd, fused_fwd

    d = _check_mesh(mesh, n_ty)
    rows_per = n_ty // d
    metas = _band_metas(tile_starts, d, rows_per * n_tx, rows_per)
    slots = _replicas(mesh, slot3d)

    def band_fwd(i, b, dev, cam_d):
        meta = metas[b].to(dev)
        out, cd = fused_fwd(slots[i], meta, cam_d, rows_per, n_tx, near, far)
        return out, (meta, out, cd)

    def band_bwd(i, b, dev, cam_d, saved, cot):
        meta, out, cd = saved
        px_in = torch.cat([out, cot]).contiguous()
        return _d_cam(fused_bwd(slots[i], meta, cam_d, cd, px_in, rows_per,
                                n_tx, near, far))

    return _BandRender.apply(cam, mesh, band_fwd, band_bwd)


def sharded_subtile_render(
    slot3d,  # (8, M_pad) 3D slot buffer, replicated
    subtile_starts,  # (n_ty*n_tx*N_SUB + 1,) int32
    cam,  # (18,) camera scalar vector (differentiable)
    n_ty: int,
    n_tx: int,
    mesh: TileMesh,
    near: float,
    far: float,
):
    """Tile-row-banded sub-tile tracking render (ops/fused_subtile.py): the
    sub-tile ids are row-major within each (16, 128) macro tile, so a band
    of macro-tile rows owns a contiguous slice of the sub-tile starts.
    Every band projects the slots (K4a, replicated as in the JAX package)
    and walks its rows (K4b); the backward runs K5a and K5b per band, the
    12 pose partials summed in band order. Returns (depth_acc, alpha) on
    the mesh's first device."""
    from ..ops.fused_subtile import (
        N_SUB, project8, scramble_image, subtile_bwd, subtile_chain,
        subtile_fwd, unscramble_image,
    )

    d = _check_mesh(mesh, n_ty)
    rows_per = n_ty // d
    metas = _band_metas(subtile_starts, d, rows_per * n_tx * N_SUB, rows_per)
    slots = _replicas(mesh, slot3d)

    def band_fwd(i, b, dev, cam_d):
        meta = metas[b].to(dev)
        proj8 = project8(slots[i], cam_d, near, far)
        out, cd = subtile_fwd(proj8, meta, rows_per, n_tx)
        img = torch.stack([unscramble_image(out[0], rows_per, n_tx),
                           unscramble_image(out[1], rows_per, n_tx)])
        return img, (meta, proj8, out, cd)

    def band_bwd(i, b, dev, cam_d, saved, cot):
        meta, proj8, out, cd = saved
        sin = torch.stack([out[0], out[1],
                           scramble_image(cot[0], rows_per, n_tx),
                           scramble_image(cot[1], rows_per, n_tx)])
        mom = subtile_bwd(proj8, sin.contiguous(), meta, rows_per, n_tx, cd)
        return _d_cam(subtile_chain(slots[i], mom, cam_d, meta, n_tx)[0])

    return _BandRender.apply(cam, mesh, band_fwd, band_bwd)


def _pad_starts(starts, extra: int):
    """Segment starts with `extra` empty segments appended: the padded rows
    of a tile grid cut into bands, each starting where the last one ends
    (the entry points' padding, as the JAX package's wrappers pad)."""
    if extra <= 0:
        return starts
    return torch.cat([starts, starts[-1:].expand(extra)])


def _band_metas(starts, d: int, seg: int, rows_per: int):
    """(D, seg + 2) int32 meta rows [row_offset, starts slice] of the D
    bands (the shared protocol of the banded wrappers)."""
    idx = (torch.arange(d, device=starts.device)[:, None] * seg
           + torch.arange(seg + 1, device=starts.device)[None, :])
    row_offs = (torch.arange(d, device=starts.device) * rows_per)[:, None]
    return torch.cat([row_offs.to(torch.int32),
                      starts.to(torch.int32)[idx]], dim=1)


def sharded_kcover_build(
    slot3d,  # (8, B_pad) 3D slot buffer, replicated
    subtile_starts,  # (n_ty*n_tx*N_SUB + 1,) int32
    cam,  # (N_CAM,) camera scalar vector (selection pose)
    n_ty: int,
    n_tx: int,
    mesh: TileMesh,
    near: float,
    far: float,
    k_cover: int,
    via: str = "records",
):
    """Tile-row-banded K-cover selection (ops/kcover.py): every band walks
    its sub-tile segments and selects its pixels' first-K cover records,
    routed on K as `build_kcover_buffer` routes them (K3, or K4a + K8 and
    the row gather). The scrambled pixel layout is sub-tile-row-major, so
    a band owns a contiguous pixel slice. Returns the list of this
    process's bands' (NREC_KC, K, m_out_band) buffers, each on its band's
    device (concatenated along the pixel axis over all bands: the
    single-device buffer)."""
    from ..ops.fused_subtile import N_SUB
    from ..ops.kcover import build_kcover_buffer

    d = _check_mesh(mesh, n_ty)
    rows_per = n_ty // d
    metas = _band_metas(subtile_starts, d, rows_per * n_tx * N_SUB, rows_per)
    slots = _replicas(mesh, slot3d)
    out = []
    for i, b, dev in mesh.local_bands():
        with _on(dev):
            out.append(build_kcover_buffer(
                slots[i], metas[b].to(dev), cam.detach().to(dev), rows_per,
                n_tx, near, far, k_cover=k_cover, via=via))
    return out


def sharded_kcover_render(
    kbuf,  # list of this process's bands' (NREC_KC, K, m_out_band) buffers
    cam,  # (N_CAM,) camera scalar vector (differentiable)
    n_ty: int,
    n_tx: int,
    mesh: TileMesh,
    near: float,
    far: float,
):
    """Per-step K-cover render over the pixel-banded cover buffer: every
    band projects and composites its pixels at their global rows (K1 with
    the band's first pixel row row0_px) against the replicated cam vector;
    K2 gives each band's 12 pose partials, summed in band order. Returns
    (depth_acc, alpha) on the mesh's first device."""
    from ..ops.binning import TILE_H
    from ..ops.fused_subtile import scramble_image, unscramble_image
    from ..ops.kcover import kcover_step_bwd, kcover_step_fwd

    d = _check_mesh(mesh, n_ty)
    rows_per = n_ty // d
    if len(kbuf) != len(mesh.devices):
        raise ValueError(f"{len(kbuf)} band buffers for "
                         f"{len(mesh.devices)} local bands")

    def band_fwd(i, b, dev, cam_d):
        row0 = float(b * rows_per * TILE_H)
        out = kcover_step_fwd(kbuf[i], cam_d, rows_per, n_tx, near, far, row0)
        img = torch.stack([unscramble_image(out[0], rows_per, n_tx),
                           unscramble_image(out[1], rows_per, n_tx)])
        return img, (row0, out)

    def band_bwd(i, b, dev, cam_d, saved, cot):
        row0, out = saved
        g_d = scramble_image(cot[0], rows_per, n_tx).contiguous()
        g_a = scramble_image(cot[1], rows_per, n_tx).contiguous()
        return _d_cam(kcover_step_bwd(kbuf[i], cam_d, rows_per, n_tx, near,
                                      far, g_d, g_a, out, row0))

    return _BandRender.apply(cam, mesh, band_fwd, band_bwd)
