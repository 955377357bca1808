"""DRAM-side operand layouts; PyTorch port of the part of `repro.core.layout`
the trace generator needs. The on-chip bank-conflict model (the layout
stage) belongs to a later slice of the port.
"""
from __future__ import annotations

DRAM_LAYOUTS = ("row", "col", "tiled", "strided")


def operand_linear_index(row, col, rows, cols, order: str = "row",
                         tile_r: int = 32, tile_c: int = 32):
    """DRAM-side storage layout: operand element (row, col) of a
    rows x cols matrix -> linear element offset within its region.

    - 'row':   row-major (C order);
    - 'col':   column-major (Fortran order);
    - 'tiled': tile_r x tile_c blocks laid out row-major, row-major inside
               each block.

    `row`/`col`/`rows`/`cols` are float32 tensors; `order`, `tile_r` and
    `tile_c` are static. ('strided' is synthesized directly from the stream
    position in the generator, not from coordinates.)
    """
    if order == "row":
        return row * cols + col
    if order == "col":
        return col * rows + row
    if order == "tiled":
        tiles_per_row = -(-cols // tile_c)
        tile_id = (row // tile_r) * tiles_per_row + (col // tile_c)
        return (tile_id * (tile_r * tile_c)
                + (row % tile_r) * tile_c + (col % tile_c))
    raise ValueError(f"unknown DRAM layout order {order!r}; "
                     f"known: {DRAM_LAYOUTS}")
