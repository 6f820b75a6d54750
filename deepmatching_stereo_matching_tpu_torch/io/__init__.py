"""Host-side image I/O (C1/C14, SURVEY.md §1 L0): loaders + writers."""

from .images import load_image, load_pair
from .writers import (
    read_disparity_png16,
    read_pfm,
    write_disparity_color,
    write_disparity_png16,
    write_pfm,
    write_valid_mask,
)

__all__ = [
    "load_image",
    "load_pair",
    "read_disparity_png16",
    "read_pfm",
    "write_disparity_color",
    "write_disparity_png16",
    "write_pfm",
    "write_valid_mask",
]
