"""csrc/decode_stack.cu gemv_kernel: the decode step's four products a
layer (ln_gemv_bf16 for c_attn and mlp.c_fc, whose LayerNorm is the
prologue; gemv_bf16 for attn.c_proj and mlp.c_proj, with the residual in
the epilogue). Bytes: the staged weight, bias and LayerNorm parameters,
the input rows, the residual rows and the outputs (c_attn writes its
output in bf16 and in fp32), each once."""

import re

from benchmark.reference import prior as ref

PATTERN = re.compile(r"gemv_kernel")

WEIGHT_BYTES = {"bf16": 2, "int8": 1}


def step_launches(hp, batch, weights="bf16"):
    """[(bytes, flops)] of one decode step's GEMV launches."""
    W = hp["prior_width"]
    A, M = int(hp["m_attn"] * W), int(hp["m_mlp"] * W)
    wb = WEIGHT_BYTES[weights]
    B = batch

    def gemv(K, N, ln=False, res=False, out32=False):
        nbytes = K * N * wb + N * 2 + B * K * 2 + B * N * 2
        if weights == "int8":
            nbytes += N * 4
        if ln:
            nbytes += 2 * K * 4
        if res:
            nbytes += B * N * 2
        if out32:
            nbytes += B * N * 4
        return nbytes, 2 * B * K * N
    out = []
    for d in range(hp["prior_depth"]):
        q = A if ref.attn_func(hp, d) == 6 else 3 * A
        out += [gemv(W, q, ln=True, out32=True), gemv(A, W, res=True),
                gemv(W, M, ln=True), gemv(M, W, res=True)]
    return out


def launches(work, hp):
    out = []
    for w in work:
        if w["kind"] == "decode_step":
            out += step_launches(hp, w["batch"], w.get("weights", "bf16"))
    return out
