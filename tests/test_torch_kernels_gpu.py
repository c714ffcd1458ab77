"""Each CUDA kernel against its plain PyTorch version.

Decode kernels (ops/decode_stack.py) at the 1b_lyrics priors' shapes: every
attention pattern at positions crossing block and prime boundaries, and the
slot each writes. Tolerance 1e-2 x max(1, |plain|): the two sum in different
orders in fp32 and can round one bf16 output differently.

Flash kernels (ops/flash_attention.py) through chip_smoke.check_flash, at
L 1000 and a ragged 517 with head widths 64 and 256, at dropout rates 0
and 0.1: out, lse, dq, dk, dv held to ops/flash_attention.py `agreement`
(elementwise: two bf16 steps of |plain| plus 2^-5 of the row's RMS, where
the kernels round p and ds to bf16 for their second products and the plain
versions keep fp32; lse 1e-5 relative), and each kernel fed a planted fault
(one tile skipped) refused by the same check.

LayerNorm kernels (ops/layer_norm.py) through chip_smoke.check_layer_norm
at ragged and wide shapes in fp32, bf16 and fp16: y, mu, rstd, dx, dg, db
held to ops/layer_norm.py `agreement` (elementwise: two steps of the
output dtype of |plain| plus 1e-4 of the tensor's RMS), and a planted
fault (the last row skipped) refused by the same check.

The Adam kernel (ops/adam.py) through chip_smoke.check_adam on a few
tensors of mixed sizes (one with a None gradient), both moment forms,
three updates: params normwise within 1e-6 of how far they moved, moments
within one fp16 step (or 1e-6 normwise in fp32), and a planted fault (the
last chunk of the largest tensor left out) refused.

Needs a CUDA device and skips itself without one. This file imports no JAX,
so it runs on a GPU machine that has only the port's dependencies:
    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jukebox_tpu_torch.ops import decode_stack as ds
from jukebox_tpu_torch.ops import flash_attention as fa
from jukebox_tpu_torch.ops import layer_norm as ln

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def _rel_err(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / max(1.0, np.abs(ref).max())


@pytest.mark.gpu
@pytest.mark.parametrize("S,A,H,bc,blocks,n_ctx,prime", [
    (2048, 512, 2, 102, 64, 6528, 448),   # top prior (order 12)
    (1920, 480, 1, 64, 128, 8192, None),  # upsamplers (order 2)
], ids=["top", "upsampler"])
def test_cuda_kernels_match_plain(S, A, H, bc, blocks, n_ctx, prime):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def close(out, ref):
        assert _rel_err(out.float().cpu(), ref.float().cpu()) <= 1e-2

    B = 4
    x, g, b = rnd(B, S), rnd(S, dtype=torch.float32), rnd(S, dtype=torch.float32)
    close(ds.ln_rows(x, g, b), ds.ln_rows_plain(x, g, b))
    for K, N, epi in ((S, 3 * A, None), (A, S, "residual"), (S, S, "gelu"),
                      (S, S, "residual")):
        x, w, b = rnd(B, K), rnd(K, N, scale=0.02), rnd(N, scale=0.02)
        res = rnd(B, N) if epi == "residual" else None
        close(ds.gemv_bf16(x, w, b, epi, res),
              ds.gemv_bf16_plain(x, w, b, epi, res))
    shapes = {0: (B, n_ctx, A), 1: (B, bc, A), 2: (B, bc, blocks, A),
              3: (B, 2 * bc, A), 7: (B, prime or 0, A)}
    for f in ((0, 1, 2, 3, 7) if prime else (1, 2, 3)):
        kc, vc = rnd(*shapes[f]), rnd(*shapes[f])
        for t in (0, bc - 1, bc, 2 * bc + 1, 447, 448, 2000):
            geom = ds.ring_geometry(f, t, shapes[f], bc, prime)
            qkv = rnd(B, 3 * A)
            k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            close(ds.ring_attn_decode(qkv, k1, v1, geom, H),
                  ds.ring_attn_decode_plain(qkv, k2, v2, geom, H))
            assert torch.equal(k1, k2) and torch.equal(v1, v2)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 256])
def test_flash_kernels_match_plain(hd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rows = chip_smoke.check_flash(3, 1000, hd, 1, "cuda",
                                  torch.Generator(device="cuda").manual_seed(1),
                                  time_it=False, ragged=517)
    assert set(rows) == set(fa.LAUNCHES)


@pytest.mark.gpu
def test_layer_norm_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rows = chip_smoke.check_layer_norm(
        [(1000, 1000, torch.bfloat16), (517, 1920, torch.float32),
         (64, 2048, torch.float16), (3, 12288, torch.bfloat16),
         (2, 7, torch.float32)],
        "cuda", torch.Generator(device="cuda").manual_seed(2),
        time_it=False)
    assert set(rows) == set(ln.LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("fp16", [False, True])
def test_adam_kernel_matches_plain(fp16):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [(2048, 1536), (2048,), (7,), (1000, 33), (70000,)]
    start = {f"t{i}": 0.02 * torch.randn(shape, generator=gen, device="cuda")
             for i, shape in enumerate(shapes)}
    row = chip_smoke.check_adam(start, fp16, "cuda", time_it=False)
    assert row["max_abs_err"] >= 0.0
