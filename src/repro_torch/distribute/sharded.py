"""Sharded execution of the filter datapath over a (batch, rows) grid of
devices, with halo-correct row bands.

Counterpart of `repro.distribute.sharded`. The reference runs its passes
under `shard_map` from one controller; the port runs in one process too:
each shard's input is cut on the caller's device, copied to the shard's
device, and run through the ordinary local pass there (launches are
asynchronous, so the shards of several cards overlap), and the outputs are
gathered back. No `torch.distributed` group is needed.

Every wrapper is bit-identical to its single-device counterpart: the
passes' outputs do not depend on the grid, so a shard only has to see the
input window the local pass would read. Whole images ride the `batch`
axis with no halo; row bands ride the `rows` axis and source their kh//2
halo rows one of two ways:

  * halo='exchange' -- each shard takes ph rows from the shard above and
    below (copied between the shards' tensors, the counterpart of the
    reference's `ppermute`); a shard at the image's top or bottom edge
    takes zero rows, which stand in for `ppermute`'s zero fill and are the
    zero padding the local pass reads there.
  * halo='embedded' -- overlapping (hl + 2*ph)-row windows are cut from the
    zero-padded global batch, so no rows move between shards.

Either way each shard runs the local pass on its extended band and crops
the ph halo output rows. The pass runs with the shard-local shape, so the
tuning cache is consulted with per-shard keys (`mesh.shard_local_shape`),
never the global one. Non-divisible batches pad with zero images and
non-divisible (or smaller-than-one-shard) row counts with zero rows
(`mesh.shard_dims`), cropped from the output.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.platform import resolve_device
from repro_torch.distribute.mesh import filter_mesh, shard_dims
from repro_torch.filters.bank import FilterSpec, get_filter
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.fault import SITE_SHARD
from repro_torch.runtime.fault import probe as fault_probe

HALO_MODES = ("exchange", "embedded")


def _exchange(bands: list[torch.Tensor], r: int, ph: int) -> torch.Tensor:
    """Band r of one batch slice with ph rows of its neighbours above and
    below (zeros at the image's edges), on band r's device."""
    x = bands[r]
    zeros = x.new_zeros((x.shape[0], ph, x.shape[2]))
    up = bands[r - 1][:, -ph:].to(x.device) if r > 0 else zeros
    dn = bands[r + 1][:, :ph].to(x.device) if r + 1 < len(bands) else zeros
    return torch.cat([up, x, dn], dim=1)


def sharded_call(pass_fn: Callable, pass_key: tuple, imgs: torch.Tensor, ph: int, *,
                 devices: int | Sequence[int] | None = None,
                 mesh_shape: tuple[int, int] | None = None,
                 halo: str = "exchange") -> torch.Tensor:
    """Run `pass_fn` (an (N, H, W) -> (N, H, W) map needing ph halo rows,
    run on its input's device) sharded over a (batch, rows) mesh of
    devices of `imgs`' type; -> the output on `imgs`' device. `pass_key`
    names the pass (its first item keys the fault probes)."""
    if halo not in HALO_MODES:
        raise ValueError(f"halo must be one of {HALO_MODES}, got {halo!r}")
    n, h, w = imgs.shape
    mesh = filter_mesh(devices, mesh_shape, n=n, device=imgs.device)
    nb, nr = mesh.shape
    if nr == 1:
        # no row sharding -> no halo of either kind: the plain pass per batch
        # shard, at `shard_local_shape`
        halo = "exchange"
    n2, h2, hl = shard_dims(n, h, nb, nr, ph)
    # one fault probe (and trace event) per participating shard before any
    # dispatch: a matching rule models that shard's device failing the call
    traced = obs_trace.tracing()
    for shard, dev_id in enumerate(mesh.ids.flat):
        fault_probe(SITE_SHARD, key=f"{pass_key[0]}/{halo}/dev{dev_id}", index=shard)
        if traced:
            obs_trace.emit("shard", filt=pass_key[0], halo=halo, shard=shard,
                           dev=int(dev_id), n=n)
    x = imgs
    if n2 != n or h2 != h:
        x = F.pad(x, (0, 0, 0, h2 - h, 0, n2 - n))
    nl = n2 // nb
    outs = []
    for b in range(nb):
        part = x[b * nl:(b + 1) * nl]
        if halo == "embedded":
            padded = F.pad(part, (0, 0, ph, ph))
            wins = [padded[:, r * hl:r * hl + hl + 2 * ph].to(mesh.devices[b, r])
                    for r in range(nr)]
            band_outs = [pass_fn(win)[:, ph:ph + hl] for win in wins]
        else:
            bands = [part[:, r * hl:(r + 1) * hl].to(mesh.devices[b, r])
                     for r in range(nr)]
            if nr > 1 and ph > 0:
                band_outs = [pass_fn(_exchange(bands, r, ph))[:, ph:ph + hl]
                             for r in range(nr)]
            else:
                band_outs = [pass_fn(band) for band in bands]
        outs.append(torch.cat([o.to(imgs.device) for o in band_outs], dim=1))
    return torch.cat(outs, dim=0)[:n, :h]


def sharded_conv2d_pass(imgs, taps, *, devices: int | Sequence[int] | None = None,
                        mesh_shape: tuple[int, int] | None = None,
                        halo: str = "exchange",
                        device: str | torch.device | None = None, **kw) -> torch.Tensor:
    """`repro_torch.filters.conv.conv2d_pass` over the (batch, rows) mesh
    of `device`'s type, bit-identical to the local pass; `kw` is forwarded."""
    from repro_torch.filters.conv import _host_taps, conv2d_pass
    taps = _host_taps(taps)
    x = torch.as_tensor(imgs).to(resolve_device(device), torch.int32)
    return sharded_call(lambda t: conv2d_pass(t, taps, **kw), ("conv2d",), x,
                        int(taps.shape[0]) // 2, devices=devices,
                        mesh_shape=mesh_shape, halo=halo)


def sharded_fused_separable_pass(imgs, row, col, *,
                                 devices: int | Sequence[int] | None = None,
                                 mesh_shape: tuple[int, int] | None = None,
                                 halo: str = "exchange",
                                 device: str | torch.device | None = None,
                                 **kw) -> torch.Tensor:
    """`repro_torch.filters.conv.fused_separable_pass` over the mesh."""
    from repro_torch.filters.conv import _host_taps, fused_separable_pass
    row, col = _host_taps(row), _host_taps(col)
    x = torch.as_tensor(imgs).to(resolve_device(device), torch.int32)
    return sharded_call(lambda t: fused_separable_pass(t, row, col, **kw), ("fused",),
                        x, int(col.size) // 2, devices=devices,
                        mesh_shape=mesh_shape, halo=halo)


def sharded_apply_filter(imgs, filt: FilterSpec | str, *,
                         devices: int | Sequence[int] | None = None,
                         mesh_shape: tuple[int, int] | None = None,
                         halo: str = "exchange",
                         device: str | torch.device | None = None,
                         **kw) -> torch.Tensor:
    """`repro_torch.filters.apply_filter` over the (batch, rows) mesh of
    `device`'s type (the card for None).

    Accepts the local entry point's image shapes and filter keywords
    (method, nbits, separable, fused, mult_impl, block_*) and returns the
    same uint8 tensor on `device`. Each shard's pass resolves its plan from
    the shard-local shape."""
    from repro_torch.filters.pipeline import _normalize, _restore, apply_filter
    spec = get_filter(filt) if isinstance(filt, str) else filt
    arr, orig = _normalize(imgs, resolve_device(device))
    out = sharded_call(lambda t: apply_filter(t, spec, device=t.device, **kw),
                       ("filter", spec.name), arr, int(spec.taps.shape[0]) // 2,
                       devices=devices, mesh_shape=mesh_shape, halo=halo)
    return _restore(out, orig)


__all__ = ["HALO_MODES", "sharded_apply_filter", "sharded_call",
           "sharded_conv2d_pass", "sharded_fused_separable_pass"]
