"""Word maps: vertex bitmaps packed 32 vertices to an int32 word.

Rule (the JAX package's, `ops/pallas_advance.py::pack_bitmap`): bit b
of word w is vertex 32*w + b.  A map over n vertices is a (rows, 128)
int32 array with rows = 8 * ceil((n + 1) / 32768), i.e. whole 32K-vertex
regions as the reference's mega plan lays them out (264 rows at
rmat-s20); vertex n (the dummy) and the padding stay 0.
"""

from __future__ import annotations

import numpy as np
import torch

REGION = 32768                  # vertices per 8-row region
ROWS_PER_REGION = REGION // 32 // 128


def word_rows(n: int) -> int:
    """Rows of the (rows, 128) word map of an n-vertex graph."""
    return -(-(n + 1) // REGION) * ROWS_PER_REGION


def start_words(v: int, rows: int, device) -> torch.Tensor:
    """The (rows, 128) word map holding only vertex `v`."""
    words = torch.zeros((rows, 128), dtype=torch.int32, device=device)
    bit = np.array([1 << (v & 31)], np.uint32).view(np.int32)
    words.view(-1)[v >> 5] = int(bit[0])
    return words


def pack_bitmap(mask: torch.Tensor, n_words: int) -> torch.Tensor:
    """(k,) bool -> (n_words/128, 128) int32 packed words (k <= 32*n_words)."""
    if mask.dim() != 1 or mask.shape[0] > n_words * 32:
        raise ValueError(f"mask of shape {tuple(mask.shape)} does not fit "
                         f"{n_words} words")
    bits = torch.zeros(n_words * 32, dtype=torch.int64, device=mask.device)
    bits[: mask.shape[0]] = mask.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (bits.view(n_words, 32) << shifts).sum(dim=1)  # in [0, 2^32)
    words = words - ((words >> 31) << 32)                  # wrap to int32
    return words.to(torch.int32).view(n_words // 128, 128)


def unpack_bitmap(words: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(rows, 128) int32 -> (n_pad,) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.reshape(-1, 1) >> shifts) & 1
    return bits.reshape(-1)[:n_pad].to(torch.bool)


def host_unpack_words(words_np: np.ndarray, n: int) -> np.ndarray:
    """(rows, 128) int32 words -> (n,) uint8 bits, on the host.
    np.unpackbits over the little-endian byte view yields exactly vertex
    order (bit b of word w = vertex 32w+b)."""
    return np.unpackbits(np.ascontiguousarray(words_np).reshape(-1).view(
        np.uint8), bitorder="little")[:n]


def words_from_mask(mask: np.ndarray, n_words: int) -> np.ndarray:
    """(k,) bool -> (n_words/128, 128) int32 word map, on the host
    (the JAX package's `pallas_value.words_from_mask`)."""
    bits = np.zeros(n_words * 32, np.uint8)
    bits[: mask.shape[0]] = mask.astype(np.uint8)
    words = np.packbits(bits, bitorder="little").view(np.int32)
    return words.reshape(-1, 128)


def mask_from_words(words: np.ndarray, n: int) -> np.ndarray:
    """(rows, 128) int32 word map -> (n,) bool, on the host."""
    return host_unpack_words(words, n).astype(bool)
