"""Pattern dictionary: factor shared sparsity structure out of per-item rows.

The port's own copy of ``repro.compress.patterns``, in torch.  The
tessellation map sends every item of a cell to the same sparsity pattern,
so the (n, words) packed-bitset rows are highly redundant: the dictionary
stores the distinct rows once plus a per-item int32 index, and
``uniq[inverse]`` gives the rows back bit for bit.

Pattern ids are the rows' lexicographic order over their uint32 words, as
``np.unique(bits, axis=0)`` numbers them in the reference; that order fixes
the varint bytes of a compressed index, so the two packages give the same
ids.  Words are held widened to int64 (values ``0 .. 2^32 - 1``), which
keeps their order and needs no unsigned arithmetic, and the rows are sorted
by one stable sort a word, last word first.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pattern_dict_decode", "pattern_dict_encode", "pattern_dict_nbytes"]


def _words(bits) -> torch.Tensor:
    """(n, words) uint32 values (numpy or tensor) -> int64 tensor, same
    values, on the tensor's device (numpy: the host)."""
    if isinstance(bits, torch.Tensor):
        t = bits.to(torch.int64)
        if bits.dtype == torch.int32:         # uint32 bits held as int32
            t &= 0xFFFFFFFF
        return t
    return torch.from_numpy(np.ascontiguousarray(bits, np.uint32)
                            .astype(np.int64))


def pattern_dict_encode(bits) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, words) uint32 rows -> (unique rows (u, words) int64 holding the
    uint32 values in lexicographic order, inverse (n,) int32)."""
    words = _words(bits)
    if words.dim() != 2:
        words = words.reshape(words.shape[0], -1)
    n = words.shape[0]
    if n == 0:
        return words, torch.empty(0, dtype=torch.int32, device=words.device)
    order = torch.arange(n, device=words.device)
    for w in reversed(range(words.shape[1])):
        order = order[torch.argsort(words[order, w], stable=True)]
    rows = words[order]
    new = torch.ones(n, dtype=torch.bool, device=words.device)
    new[1:] = (rows[1:] != rows[:-1]).any(dim=1)
    ids = torch.cumsum(new.to(torch.int64), 0) - 1
    inverse = torch.empty(n, dtype=torch.int32, device=words.device)
    inverse[order] = ids.to(torch.int32)
    return rows[new], inverse


def pattern_dict_decode(uniq, inverse) -> torch.Tensor:
    """Inverse of :func:`pattern_dict_encode` (bit-exact)."""
    uniq = _words(uniq)
    inverse = torch.as_tensor(inverse, device=uniq.device).to(torch.int64)
    return uniq[inverse]


def pattern_dict_nbytes(uniq, inverse) -> int:
    """Bytes of the dictionary at its storage types: uint32 words, int32
    ids (the reference's count)."""
    def size(a) -> int:
        return a.numel() if isinstance(a, torch.Tensor) else np.asarray(a).size
    return 4 * size(uniq) + 4 * size(inverse)
