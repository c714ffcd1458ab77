"""csrc/decode_stack.cu gemv_kernel (ln_gemv_bf16, gemv_bf16): percent of
its roofline in the traced segment."""

from benchmark import readers


def read(r):
    return readers.roofline(r, "decode_gemv")
