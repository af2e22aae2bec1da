"""Codecs of the compressed catalog, in the port.

Counterpart of ``repro.compress`` (the port imports nothing of ``repro``):

* :mod:`repro_torch.compress.postings`: delta + group-varint coding of
  sorted posting lists (numpy, lossless, the reference's bytes).
* :mod:`repro_torch.compress.quantize`: int8 factor blocks with per-block
  f32 scales (torch, any device, the reference's bytes), decoded inside the
  retrieval kernel and made exact again by the f32 re-rank.
* :mod:`repro_torch.compress.patterns`: the pattern dictionary (torch, the
  reference's pattern ids), which factors the ``gam`` backend's compressed
  inverted index.
"""
from repro_torch.compress.patterns import (pattern_dict_decode,
                                           pattern_dict_encode,
                                           pattern_dict_nbytes)
from repro_torch.compress.postings import (CodecError, CompressedPostings,
                                           decode_postings, delta_decode,
                                           delta_encode, encode_postings,
                                           group_varint_decode,
                                           group_varint_encode)
from repro_torch.compress.quantize import (dequantize_int8,
                                           quantization_error_bound,
                                           quantize_int8, score_error_bound)

__all__ = [
    "CodecError", "CompressedPostings", "decode_postings", "delta_decode",
    "delta_encode", "dequantize_int8", "encode_postings",
    "group_varint_decode", "group_varint_encode", "pattern_dict_decode",
    "pattern_dict_encode", "pattern_dict_nbytes", "quantization_error_bound",
    "quantize_int8", "score_error_bound",
]
