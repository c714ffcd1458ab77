"""csrc/decode_stack.cu attn_kernel (ring_attn_decode): percent of its
roofline in the traced segment."""

from benchmark import readers


def read(r):
    return readers.roofline(r, "decode_attn")
