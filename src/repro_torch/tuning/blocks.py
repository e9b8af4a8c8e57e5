"""Block-shape vocabulary, the Hopper kernels' tile menu, and the cache-miss
defaults of the conv passes.

Counterpart of `repro.tuning.blocks`. A `BlockConfig` names one grid
organization of a conv pass:

  * `block_rows` -- height of one output row band (on the card: the rows
                    of one block's output tile);
  * `block_cols` -- width of one output column tile, or None for the full
                    image width;
  * `batch_fold` -- fold the batch into the row axis, each image with its
                    own kh//2-row zero halo.

The vocabulary is read per backend:

  * 'cpu' -- the reference's, with its heuristic (`default_blocks`)
    verbatim. The port runs the plain PyTorch versions there, which
    ignore the grid (the bytes never depend on it), so on the CPU the
    blocks are only validated and tuned as the reference's are.
  * 'cuda' -- the tiles the Hopper kernels are compiled for (`TILE_MENU`).
    Each of the four persistent kernels (`conv_pass_kcm`,
    `conv_pass_recurse`, `fused_separable_kcm`, `fused_separable_recurse`)
    takes its tile as a template parameter and is built once per menu
    tile; the tiled kernels, which run any other tap shape, have one
    tile. `kernel_route` says which route a tap shape takes. The kernels
    never fold a batch into rows: a grid runs N independent images, so
    `batch_fold=True` on the card is refused (`menu_tile`). A cache miss
    takes the route's first tile, the one the kernels had before the menu.

Measured winners live in the per-backend JSON cache (`repro_torch.tuning.
cache`, written by `repro_torch.tuning.autotune`).
"""
from __future__ import annotations

from typing import NamedTuple

#: block_rows candidates for divisor-based row banding, best (deepest) first.
_BLOCK_ROWS = (128, 64, 32, 16, 8)

#: soft ceiling on a row band's height (the reference's VMEM bound).
MAX_BLOCK_ROWS = 1024

#: tap shapes the persistent kernels are compiled for (the bank's), direct
#: and fused; any other shape runs the tiled kernels.
PERSISTENT_SHAPES = ((3, 3), (5, 5), (1, 3), (3, 1), (1, 5), (5, 1))
FUSED_PERSISTENT_SHAPES = ((3, 3), (5, 5))

#: route -> the output tiles (rows, cols) one block computes, compiled on
#: the card; the first is a cache miss's. The persistent tiles are
#: `TileShape`s of csrc/staging.cuh (2 x rows-a-thread by columns, one
#: library a tile, `repro_torch.kernels.build`); the tiled kernels' 16 x 32
#: is their kTileH x kTileW.
TILE_MENU: dict[str, tuple[tuple[int, int], ...]] = {
    "persistent": ((32, 64), (16, 64)),
    "tiled": ((16, 32),),
}


class BlockConfig(NamedTuple):
    """One grid organization of the conv datapath."""

    block_rows: int
    block_cols: int | None      # None = full width (no column tiling)
    batch_fold: bool

    def as_dict(self) -> dict:
        return {"block_rows": self.block_rows, "block_cols": self.block_cols,
                "batch_fold": self.batch_fold}


def round_up(x: int, mult: int) -> int:
    return -(-int(x) // mult) * mult


def min_block_rows(kh: int) -> int:
    """Shallowest legal row band on the CPU vocabulary (the reference's
    fused-pass floor)."""
    return max(2 * (kh // 2), 8)


def min_block_cols(kw: int) -> int:
    """Narrowest legal column tile on the CPU vocabulary: it must hold the
    kw//2-column halo on each side."""
    return max(2 * (kw // 2), 8)


def choose_block_rows(h: int) -> int:
    """Largest divisor-candidate band height for an unfolded image of H rows
    (else the minimum)."""
    for br in _BLOCK_ROWS:
        if h % br == 0:
            return br
    return _BLOCK_ROWS[-1]


def kernel_route(kh: int, kw: int, *, fused: bool = False) -> str:
    """Which kernel runs a (kh, kw) tap shape on the card: 'persistent' for
    the shapes it is compiled for (PERSISTENT_SHAPES for a direct pass,
    FUSED_PERSISTENT_SHAPES for the fused one), 'tiled' for any other."""
    shapes = FUSED_PERSISTENT_SHAPES if fused else PERSISTENT_SHAPES
    return "persistent" if (kh, kw) in shapes else "tiled"


def route_of(kind: str, kh: int, kw: int) -> str:
    """The route of a pass of `kind` ('direct' | 'fused')."""
    return kernel_route(kh, kw, fused=kind == "fused")


def menu_tile(route: str, block_rows: int | None, block_cols: int | None,
              batch_fold: bool | None) -> tuple[int, int]:
    """The card's tile for explicit grid fields on `route`: (rows, cols) of
    the menu, unset fields taken from the route's first tile with the same
    given field. Raises ValueError for a tile off the menu (as the
    reference fails loud on an illegal explicit `block_cols`). The tile
    does not depend on `batch_fold`: a fold runs the same pass on the tall
    image (`filters.conv`)."""
    menu = TILE_MENU[route]
    for rows, cols in menu:
        if block_rows in (None, rows) and block_cols in (None, cols):
            return rows, cols
    raise ValueError(f"block_rows={block_rows}, block_cols={block_cols} is "
                     f"not a compiled {route} tile; the menu is {menu}")


def clamp_tile(route: str, block_rows: int, block_cols: int | None
               ) -> tuple[int, int]:
    """The menu tile a cached (not explicit) grid entry degrades to: the
    deepest menu tile no deeper than `block_rows` (else the shallowest),
    of those the widest no wider than `block_cols` (else the narrowest).
    A poisoned entry costs time, never an error."""
    menu = TILE_MENU[route]
    rows = {r for r, _ in menu}
    r = max((x for x in rows if x <= int(block_rows)), default=min(rows))
    cols = sorted(c for rr, c in menu if rr == r)
    limit = cols[-1] if block_cols is None else int(block_cols)
    c = max((x for x in cols if x <= limit), default=cols[0])
    return r, c


def default_blocks(kind: str, n: int, h: int, w: int, kh: int, kw: int, *,
                   batch_fold: bool | None = None,
                   backend: str = "cpu") -> BlockConfig:
    """Cache-miss heuristic.

    'cpu': the reference's, verbatim -- small-image batches fold into the
    row axis, the folded height cut into the fewest row bands under
    `MAX_BLOCK_ROWS`, columns tiled at 256 past 512-wide images.
    'cuda': the first menu tile of the pass's route (`kernel_route`) and no
    fold unless the caller asks for one."""
    if backend == "cuda":
        rows, cols = TILE_MENU[route_of(kind, kh, kw)][0]
        return BlockConfig(rows, cols, bool(batch_fold))
    ph = kh // 2
    fold = (n > 1 and h <= 256) if batch_fold is None else bool(batch_fold)
    if fold:
        tall = n * (h + 2 * ph)
        steps = max(1, -(-tall // MAX_BLOCK_ROWS))
        br = round_up(-(-tall // steps), 8)
    else:
        br = choose_block_rows(h)
    br = max(br, 2 * ph, 8)
    bc = None if w <= 512 else 256
    return BlockConfig(br, bc, fold)


__all__ = ["FUSED_PERSISTENT_SHAPES", "MAX_BLOCK_ROWS", "PERSISTENT_SHAPES",
           "TILE_MENU", "BlockConfig", "choose_block_rows", "clamp_tile",
           "default_blocks", "kernel_route", "menu_tile", "min_block_cols",
           "min_block_rows", "round_up", "route_of"]
