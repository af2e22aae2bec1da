"""Delta + group-varint codec for sorted posting lists.

The port's own copy of ``repro.compress.postings`` (host-side numpy, as in
the reference): it must give the reference's bytes exactly, so snapshots
with varint-coded posting tables cross between the two packages.

* **Delta encoding**: a sorted non-decreasing id list becomes its gap
  sequence (first value absolute).
* **Group varint**: gaps are byte-packed four at a time; one control byte
  carries four 2-bit fields, each the byte length (1..4) of the
  corresponding little-endian value.  A stream of ``n`` values is
  ``ceil(n/4)`` control bytes, then the data bytes (the trailing partial
  group is padded with zero-valued single-byte entries; ``n`` travels out
  of band).
* **CSR framing**: :func:`encode_postings` / :func:`decode_postings` wrap
  the codec around a whole CSR posting structure (``postings`` +
  ``offsets``), delta-resetting at every slot boundary.

Values must be non-negative and fit 32 bits; :class:`CodecError` is raised
otherwise.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CodecError", "CompressedPostings", "decode_postings",
           "delta_decode", "delta_encode", "encode_postings",
           "group_varint_decode", "group_varint_encode"]

_U32_MAX = (1 << 32) - 1


class CodecError(ValueError):
    """Input outside the codec contract (unsorted, negative, or > 32-bit
    ids) or a corrupt/truncated encoded buffer."""


# ------------------------------------------------------------------ delta


def delta_encode(ids) -> np.ndarray:
    """Sorted non-decreasing ids -> gap sequence (uint32, first absolute)."""
    ids = np.ascontiguousarray(ids, np.int64)
    if ids.size == 0:
        return np.empty(0, np.uint32)
    if int(ids[0]) < 0 or int(ids.max()) > _U32_MAX:
        raise CodecError("ids must be in [0, 2^32)")
    d = np.empty(ids.size, np.int64)
    d[0] = ids[0]
    np.subtract(ids[1:], ids[:-1], out=d[1:])
    if ids.size > 1 and int(d[1:].min()) < 0:
        raise CodecError("ids must be sorted non-decreasing")
    return d.astype(np.uint32)


def delta_decode(deltas) -> np.ndarray:
    """Inverse of :func:`delta_encode` (int64 ids)."""
    return np.cumsum(np.asarray(deltas, np.uint32).astype(np.int64))


# ----------------------------------------------------------- group varint


def _byte_lengths(v: np.ndarray) -> np.ndarray:
    nb = np.ones(v.size, np.uint8)
    nb[v >= 1 << 8] = 2
    nb[v >= 1 << 16] = 3
    nb[v >= 1 << 24] = 4
    return nb


def group_varint_encode(values) -> np.ndarray:
    """n uint32 values -> uint8 buffer (control bytes, then data bytes)."""
    v64 = np.ascontiguousarray(values, np.int64)
    if v64.size == 0:
        return np.empty(0, np.uint8)
    if int(v64.min()) < 0 or int(v64.max()) > _U32_MAX:
        raise CodecError("values must be in [0, 2^32)")
    n = v64.size
    npad = -(-n // 4) * 4
    vp = np.zeros(npad, np.uint32)
    vp[:n] = v64.astype(np.uint32)
    nb = _byte_lengths(vp)
    g = (nb - 1).reshape(-1, 4).astype(np.uint8)
    ctrl = g[:, 0] | (g[:, 1] << 2) | (g[:, 2] << 4) | (g[:, 3] << 6)
    b = vp.astype("<u4").view(np.uint8).reshape(npad, 4)
    keep = np.arange(4, dtype=np.uint8)[None, :] < nb[:, None]
    return np.concatenate([ctrl, b[keep]])


def group_varint_decode(buf, n: int) -> np.ndarray:
    """Inverse of :func:`group_varint_encode` for a known value count."""
    n = int(n)
    if n == 0:
        return np.empty(0, np.uint32)
    buf = np.ascontiguousarray(buf, np.uint8)
    ngroups = -(-n // 4)
    npad = ngroups * 4
    if buf.size < ngroups:
        raise CodecError(f"buffer holds {buf.size} bytes, "
                         f"{ngroups} control bytes expected")
    ctrl = buf[:ngroups]
    nb = np.empty((ngroups, 4), np.uint8)
    for j in range(4):
        nb[:, j] = ((ctrl >> (2 * j)) & 3) + 1
    nb = nb.reshape(npad)
    keep = np.arange(4, dtype=np.uint8)[None, :] < nb[:, None]
    data = buf[ngroups:]
    if data.size != int(nb.sum()):
        raise CodecError(f"buffer holds {data.size} data bytes, "
                         f"{int(nb.sum())} expected")
    out = np.zeros((npad, 4), np.uint8)
    out[keep] = data
    return out.view("<u4").ravel()[:n]


# ------------------------------------------------------------ CSR framing


@dataclasses.dataclass(frozen=True)
class CompressedPostings:
    """A CSR posting structure in encoded form: per-slot lengths plus one
    delta+group-varint byte stream (deltas reset at slot boundaries)."""

    data: np.ndarray      # (nbytes,) uint8 — group-varint stream
    counts: np.ndarray    # (p,) int32 per-slot posting-list lengths
    n_values: int         # total postings (== counts.sum())

    @property
    def p(self) -> int:
        return int(self.counts.size)

    @property
    def nbytes(self) -> int:
        return int(self.data.nbytes + self.counts.nbytes)


def encode_postings(postings, offsets) -> CompressedPostings:
    """CSR ``(postings, offsets)`` -> :class:`CompressedPostings`.

    Each slot's list must be sorted non-decreasing (the invariant every
    in-repo posting builder maintains: entries appear in ascending item
    order)."""
    postings = np.ascontiguousarray(postings, np.int64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    counts = np.diff(offsets).astype(np.int32)
    m = postings.size
    if m != int(offsets[-1]) or int(offsets[0]) != 0 or (
            counts.size and int(counts.min()) < 0):
        raise CodecError("offsets do not frame the postings array")
    if m == 0:
        return CompressedPostings(np.empty(0, np.uint8), counts, 0)
    if int(postings.min()) < 0 or int(postings.max()) > _U32_MAX:
        raise CodecError("postings must be in [0, 2^32)")
    d = np.empty(m, np.int64)
    d[0] = postings[0]
    np.subtract(postings[1:], postings[:-1], out=d[1:])
    starts = offsets[:-1][counts > 0]
    d[starts] = postings[starts]          # absolute restart per slot
    if int(d.min()) < 0:
        raise CodecError("slot posting lists must be sorted non-decreasing")
    return CompressedPostings(group_varint_encode(d), counts, m)


def decode_postings(cp: CompressedPostings) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`encode_postings`: bit-exact CSR reconstruction."""
    counts = np.asarray(cp.counts, np.int64)
    offsets = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    m = int(cp.n_values)
    if m != int(offsets[-1]):
        raise CodecError(f"n_values={m} != counts.sum()={int(offsets[-1])}")
    if m == 0:
        return np.empty(0, np.int64), offsets
    d = group_varint_decode(cp.data, m).astype(np.int64)
    c = np.cumsum(d)
    nz = counts > 0
    starts = offsets[:-1][nz]
    base = c[starts] - d[starts]          # running sum entering each slot
    postings = c - np.repeat(base, counts[nz])
    return postings, offsets
