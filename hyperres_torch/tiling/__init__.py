"""Paired tiling for ML dataset prep (``hyperres/tiling``)."""

from .tiles import (
    is_black_mask, tile_black_fractions, find_valid_paired_tiles,
    save_tile_pair, write_emit_b32_tile,
)

__all__ = [
    "is_black_mask", "tile_black_fractions", "find_valid_paired_tiles",
    "save_tile_pair", "write_emit_b32_tile",
]
