"""The launch plan of K7, K11, K3 and K10 (``csrc/int4_decode.cuh``),
shared by :func:`pool_decode.pool_decode_attend_int4`,
:func:`flat_decode.flat_decode_attend_int4`,
:func:`pool_decode.pool_decode_attend` and
:func:`flat_decode.flat_decode_attend`.

One launch a call, grid (row groups, S splits, sequences) of 8-warp CTAs.
A row group holds ``16 * mtc`` of a sequence's query rows (all its kv
heads x G x T, head-major); its CTAs split the sequence's work items (the
segment's 64-row tiles, 32-row tiles of bf16 rows for K3 and K10, then
16-row tiles of the row group's kv heads' tails) over S CTAs, each CTA
writes one partial, and once all S are counted every CTA merges an equal
slice of the output. The plan is made from the largest segment (the pool's
``max_rows``, the flat layout's ``R_seg``), with no read of the device; the
kernel's items stop at the segment's live rows. The functions here mirror
the kernel's arithmetic so that the CPU tests can hold it.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from kvzip_tpu_torch.ops import HEAD_DIM, ticket_buffer

WARPS = 8          # warps a CTA (csrc/int4_decode.cuh NW)
WARP_ROWS = 16     # query rows a warp (one mma tile)
ROW_TILE = 64      # int4 segment rows an item (and the q8 p tile, attention.Q8_TILE)
BF_TILE = 32       # bf16 segment rows an item (K3)
TAIL_TILE = 16     # tail rows an item
MAX_SPLITS = 256   # splits a row group the kernel's merge takes
RG_HEADS = WARP_ROWS * WARPS + 1  # kv heads a row group spans, at most


def plan(rows: int, n_seq: int, seg_rows: int, sms: int,
         row_tile: int = ROW_TILE) -> Tuple[int, int, int]:
    """(mtc, row groups, S) of a launch over ``rows`` query rows a
    sequence (kv heads x G x T, any number of kv heads) and segments of at
    most ``seg_rows`` rows in items of ``row_tile`` rows.
    A row group takes mtc 16-row tiles (2, 4 or 8 of the CTA's 8 warps;
    8 / mtc key groups split the items); S is the most splits that keep
    the grid within one CTA a SM (the merging CTAs wait for the others) and
    give each key group at least one segment tile, and at least 1 (with
    S = 1 nothing waits, so a grid wider than the card is fine)."""
    tiles = -(-rows // WARP_ROWS)
    mtc = 2 if tiles <= 2 else 4 if tiles <= 4 else 8
    groups = -(-rows // (WARP_ROWS * mtc))
    key_groups = WARPS // mtc
    seg_tiles = -(-seg_rows // row_tile)
    S = min(sms // (groups * n_seq), -(-seg_tiles // key_groups), MAX_SPLITS)
    return mtc, groups, max(1, S)


def row_group_heads(rg: int, mtc: int, rows: int, head_rows: int) -> Tuple[int, int]:
    """(first kv head, kv heads) whose query rows lie in row group rg
    (``head_rows`` = G * T query rows a kv head)."""
    r0 = rg * WARP_ROWS * mtc
    last = min(r0 + WARP_ROWS * mtc, rows) - 1
    return r0 // head_rows, last // head_rows - r0 // head_rows + 1


def work_items(seg_rows: int, tail_lens: List[int], T: int, Tcap: int,
               row_tile: int = ROW_TILE) -> list:
    """A row group's items in the kernel's order: ("seg", first row, rows)
    for each ``row_tile``-row tile of the segment, then ("tail", head index,
    first row, rows) for each 16-row tile of the visible tail rows
    (min(tail_len + T, Tcap)) of the row group's kv heads in order."""
    out = [("seg", c0, min(row_tile, seg_rows - c0)) for c0 in range(0, seg_rows, row_tile)]
    for h, tl in enumerate(tail_lens):
        n = max(0, min(tl + T, Tcap))
        out += [("tail", h, c0, min(TAIL_TILE, n - c0)) for c0 in range(0, n, TAIL_TILE)]
    return out


def split_items(n_items: int, S: int) -> List[List[int]]:
    """The items of each of the S splits, interleaved: split s takes items
    s, s + S, ... (so every CTA holds its share of each kv head's tiles, and
    a row group past T = 1 does not leave its heads' tiles to a few CTAs);
    its key groups take every ``WARPS / mtc``-th of those in turn."""
    return [list(range(s, n_items, S)) for s in range(S)]


def merge_slices(nrows: int, S: int) -> List[Tuple[int, int]]:
    """The output units [u0, u1) each split's CTA merges: float4 columns of
    the row group's nrows rows (HEAD_DIM / 4 units a row) in equal runs."""
    units = nrows * (HEAD_DIM // 4)
    per = -(-units // S)
    return [(min(s * per, units), min(s * per + per, units)) for s in range(S)]


def scratch(device: torch.device, owner: str, n_seq: int, groups: int, S: int, mtc: int):
    """The launch's partials (value rows, (m, l) pairs: n_seq x groups x S x
    16 mtc rows each) and its row groups' arrival counts."""
    rows = n_seq * groups * S * WARP_ROWS * mtc
    return (torch.empty(rows * HEAD_DIM, dtype=torch.float32, device=device),
            torch.empty(rows * 2, dtype=torch.float32, device=device),
            ticket_buffer(owner, device, n_seq * groups))
