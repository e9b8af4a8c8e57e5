"""Out-of-core execution: stream a larger-than-memory image through the
filter datapath in overlapping tiles, with crash-resume via a
completed-tile journal.

Counterpart of `repro.distribute.streamed`; `Tile`, `plan_tiles`,
`journal_fingerprint` and `load_journal` are copied from it, so a journal
written by either package names the same plan. `plan_tiles` walks the
output domain in a (tile_h, tile_w) grid and names, for every output
tile, the clipped source window that feeds it -- the tile dilated by the
filter's (ph, pw) halo -- plus the zero padding that reconstructs the part
of the halo outside the image (the zeros the local pass's own padding
reads, which is what makes stitching bit-identical). Its invariants:

  * the output tiles partition the image -- every pixel owned once;
  * every source window is the output window dilated by (ph, pw), clipped
    to the image, with `pad_*` making up exactly the clipped amount;
  * every padded window has the same (tile_h + 2*ph, tile_w + 2*pw) shape,
    so tiles stack into uniform batches (edge tiles zero-fill their tail;
    the tail outputs are cropped on write).

`stream_filter` runs the plan: the source stays a NumPy array or
`np.memmap` (only the rows a window touches are read); each group of
`tile_batch` tiles is gathered into one (k, TH, TW) int32 host batch, copied
to the device once, run through the local `apply_filter` there (any
multiplier, dataflow or mult_impl), copied back once, and the owned region
of each tile is written into `out` (a caller's array or memmap, else a new
ndarray). The datapath runs with the tile-local batch shape, so the tuning
cache is keyed on it, never on the global image.

**Crash-resume.** When `out` is a file-backed memmap (or `journal=` names a
path), a text journal records completed tiles after their output rows are
flushed: one header line fingerprinting the plan (shape x filter x tile x
datapath kwargs), then one work index per completed tile. The durability
order is: output bytes, `flush`, journal lines, `fsync`.
`stream_filter(..., resume=True)` checks the fingerprint, skips journaled
tiles and recomputes the rest -- a tile written but not yet journaled when
the process died is recomputed to the same bytes -- so a killed-then-
resumed run is byte-identical to an uninterrupted one. A torn trailing
journal line is ignored.
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np
import torch

from repro_torch.core.platform import resolve_device
from repro_torch.filters.bank import FilterSpec, get_filter
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.fault import SITE_TILE
from repro_torch.runtime.fault import probe as fault_probe

#: first token of a valid journal header line (the reference's, so the two
#: packages' journals of one plan agree)
JOURNAL_MAGIC = "repro-stream-journal v1"


class Tile(NamedTuple):
    """One tile of the plan: output ownership + clipped source window."""

    r0: int                     # owned output rows [r0, r1) ...
    r1: int
    c0: int                     # ... and columns [c0, c1)
    c1: int
    sr0: int                    # clipped source window rows [sr0, sr1) ...
    sr1: int
    sc0: int
    sc1: int                    # ... and columns
    pad_top: int                # zero rows/cols restoring the clipped halo
    pad_left: int

    @property
    def out_shape(self) -> tuple[int, int]:
        return (self.r1 - self.r0, self.c1 - self.c0)


def plan_tiles(h: int, w: int, tile_h: int, tile_w: int, ph: int,
               pw: int) -> list[Tile]:
    """Tile the (h, w) output domain; see the module docstring invariants."""
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"tile shape ({tile_h}, {tile_w}) must be positive")
    tiles = []
    for r0 in range(0, h, tile_h):
        r1 = min(h, r0 + tile_h)
        for c0 in range(0, w, tile_w):
            c1 = min(w, c0 + tile_w)
            sr0, sc0 = max(0, r0 - ph), max(0, c0 - pw)
            tiles.append(Tile(r0, r1, c0, c1,
                              sr0, min(h, r1 + ph), sc0, min(w, c1 + pw),
                              sr0 - (r0 - ph), sc0 - (c0 - pw)))
    return tiles


def _batches(seq: list, k: int) -> Iterator[list]:
    for i in range(0, len(seq), k):
        yield seq[i:i + k]


def _normalize_src(src: np.ndarray) -> tuple[np.ndarray, tuple[int, ...]]:
    """np view of the source as (N, H, W); no copy for memmaps."""
    orig = src.shape
    if src.ndim == 2:
        src = src[None]
    elif src.ndim == 4 and orig[-1] == 1:
        src = src[..., 0]
    elif src.ndim != 3:
        raise ValueError(f"expected (H,W), (N,H,W) or (N,H,W,1), got {orig}")
    return src, orig


#: datapath kwargs that identify the bytes a plan produces, filled into the
#: fingerprint so the `stream_filter` and `apply_filter(exec='streamed')`
#: spellings of one plan agree
_FP_DEFAULTS = {"method": "refmlm", "mult_impl": "auto", "nbits": 8}


def journal_fingerprint(orig: tuple, name: str, th: int, tw: int,
                        kw: dict) -> str:
    """One line identifying a stream plan and datapath: a journal written
    by a run with a different shape, tile grid, filter or filter kwargs is
    never resumed against. None-valued kwargs ("auto") are dropped and the
    byte-determining defaults filled in."""
    canon = dict(_FP_DEFAULTS)
    canon.update((k, v) for k, v in kw.items() if v is not None)
    items = ",".join(f"{k}={canon[k]!r}" for k in sorted(canon))
    return (f"shape={tuple(int(d) for d in orig)} filt={name} "
            f"tile=({th},{tw}) kw[{items}]")


def load_journal(path, fingerprint: str) -> set[int]:
    """Completed work indices from `path`; {} when the file is missing.
    Raises on a fingerprint mismatch; ignores a torn trailing line."""
    p = Path(path)
    if not p.exists() or p.stat().st_size == 0:
        return set()
    lines = p.read_text().splitlines()
    head = lines[0]
    if not head.startswith(JOURNAL_MAGIC):
        raise ValueError(f"{p} is not a {JOURNAL_MAGIC!r} journal")
    if head[len(JOURNAL_MAGIC):].strip() != fingerprint:
        raise ValueError(
            f"journal {p} was written by a different stream plan:\n"
            f"  journal: {head[len(JOURNAL_MAGIC):].strip()}\n"
            f"  call:    {fingerprint}")
    return {int(ln) for ln in lines[1:] if ln.strip().isdigit()}


def stream_filter(src, filt: FilterSpec | str, *,
                  tile: tuple[int, int] = (256, 256),
                  tile_batch: int = 8,
                  out: np.ndarray | None = None,
                  journal: str | os.PathLike | None = None,
                  resume: bool = False,
                  device: str | torch.device | None = None,
                  stats: dict | None = None,
                  **kw) -> np.ndarray:
    """Run one bank filter over an out-of-core source, tile by tile, on
    `device` (the card for None).

    `src` -- np.ndarray / np.memmap (or a tensor, copied to host memory),
    (H, W), (N, H, W) or (N, H, W, 1), integers in the uint8 pixel range;
    `tile` -- the owned output tile shape; `tile_batch` -- tiles per
    datapath call; `out` -- optional uint8 array (or memmap) of the
    source's shape; `kw` -- the local `apply_filter` keywords (method,
    nbits, separable, fused, mult_impl, block_*). Returns `out` (allocated
    if None), bit-identical to the local pass. `out` must not alias `src`.
    `journal` / `resume` are the crash-resume surface: the journal defaults
    to `<out.filename>.journal` for a file-backed memmap `out`;
    `resume=True` skips the tiles it records and needs the previous run's
    `out`; a fresh run truncates a stale journal. `stats`, when a dict, gets
    the run's counts and host-clock seconds: tiles, batches, `host_s`
    (gathering and writing tiles, journaling) and `device_s` (copy to the
    device, the filter, copy back; each batch ends in that copy)."""
    from repro_torch.filters.pipeline import apply_filter
    spec = get_filter(filt) if isinstance(filt, str) else filt
    dev = resolve_device(device)
    if isinstance(src, torch.Tensor):
        src = src.cpu().numpy()
    src = np.asarray(src) if not isinstance(src, np.ndarray) else src
    view, orig = _normalize_src(src)
    n, h, w = view.shape
    kh, kwid = (int(d) for d in spec.taps.shape)
    ph, pw = kh // 2, kwid // 2
    th, tw = (min(int(tile[0]), h), min(int(tile[1]), w))
    TH, TW = th + 2 * ph, tw + 2 * pw
    if resume and out is None:
        raise ValueError("resume=True needs the previous run's out= array "
                         "(a fresh one would leave skipped tiles unwritten)")
    if out is None:
        out = np.empty(orig, np.uint8)
    elif tuple(out.shape) != tuple(orig):
        raise ValueError(f"out shape {out.shape} != source shape {orig}")
    elif np.may_share_memory(out, view):
        # in-place streaming would read back already-written output as a
        # neighbour's halo (two memmaps of one file are not caught here)
        raise ValueError("out must not alias the source array")
    oview = out.reshape(view.shape) if out.ndim != 3 else out

    jpath = journal
    if jpath is None:
        fname = getattr(out, "filename", None)   # file-backed memmap only
        if fname is not None:
            jpath = f"{fname}.journal"
        elif resume:
            raise ValueError("resume=True needs journal= (or an out= memmap "
                             "with a filename) to know what completed")
    fp = journal_fingerprint(orig, spec.name, th, tw, kw)
    done: set[int] = set()
    jfile = None
    if jpath is not None:
        if resume:
            done = load_journal(jpath, fp)
            jfile = open(jpath, "a")
            if not Path(jpath).exists() or Path(jpath).stat().st_size == 0:
                jfile.write(f"{JOURNAL_MAGIC} {fp}\n")
        else:
            jfile = open(jpath, "w")             # truncate any stale journal
            jfile.write(f"{JOURNAL_MAGIC} {fp}\n")
        jfile.flush()

    work = [(idx, i, t)
            for idx, (i, t) in enumerate(
                (i, t) for i in range(n)
                for t in plan_tiles(h, w, th, tw, ph, pw))
            if idx not in done]
    host_s = device_s = 0.0
    batches = tiles = 0
    try:
        for group in _batches(work, max(int(tile_batch), 1)):
            t0 = time.perf_counter()
            traced = obs_trace.tracing()
            for idx, i, t in group:
                fault_probe(SITE_TILE, key=f"img{i}:r{t.r0}c{t.c0}", index=idx)
                if traced:
                    obs_trace.emit("tile", img=i, tile=idx, r0=t.r0, c0=t.c0)
            batch = np.zeros((len(group), TH, TW), np.int32)
            for b, (idx, i, t) in enumerate(group):
                batch[b, t.pad_top:t.pad_top + (t.sr1 - t.sr0),
                      t.pad_left:t.pad_left + (t.sc1 - t.sc0)] = \
                    view[i, t.sr0:t.sr1, t.sc0:t.sc1]
            t1 = time.perf_counter()
            res = apply_filter(torch.from_numpy(batch).to(dev), spec, device=dev,
                               **kw).cpu().numpy()
            t2 = time.perf_counter()
            for b, (idx, i, t) in enumerate(group):
                rows, cols = t.out_shape
                oview[i, t.r0:t.r1, t.c0:t.c1] = res[b, ph:ph + rows, pw:pw + cols]
            if jfile is not None:
                # durability order: output bytes first, then the journal
                # lines that claim them -- a crash between the two only
                # re-does work, never skips it
                if isinstance(out, np.memmap):
                    out.flush()
                jfile.write("".join(f"{idx}\n" for idx, _, _ in group))
                jfile.flush()
                try:
                    os.fsync(jfile.fileno())
                except OSError:
                    pass
            batches += 1
            tiles += len(group)
            host_s += (t1 - t0) + (time.perf_counter() - t2)
            device_s += t2 - t1
    finally:
        if jfile is not None:
            jfile.close()
        if stats is not None:
            stats.update(tiles=tiles, batches=batches, host_s=host_s,
                         device_s=device_s)
    return out


__all__ = ["JOURNAL_MAGIC", "Tile", "journal_fingerprint", "load_journal",
           "plan_tiles", "stream_filter"]
