"""Each CUDA kernel against its plain PyTorch version.

Decode kernels (ops/decode_stack.py) at the 1b_lyrics priors' shapes: every
attention pattern at positions crossing block and prime boundaries, and the
slot each writes. Tolerance 1e-2 x max(1, |plain|): the two sum in different
orders in fp32 and can round one bf16 output differently. The attention
kernels also where their rows split over blocks (f0 up to n_ctx rows, bf16
and int8; f6 over 512 and a ragged 500 encoder rows), at batch 1, 4 and 16:
the same tolerance, the same result on a second launch, and a planted fault
(one split left out of the combine) refused.

The int8 and cross-attention decode kernels (gemv_int8, ring_attn_int8,
cross_attn_decode) and the res_scale epilogues through
chip_smoke.check_int8_kernels, and the bf16 decode kernels through
chip_smoke.check_kernels, at the 5b_lyrics top's shapes (S 4800, A 1200,
8 heads of width 150, 512 encoder rows, f2 at 128 rows) and the
upsamplers': the same 1e-2 tolerance, the written rows and scales equal,
and each kernel fed a planted fault (a skipped column tile, a dropped
head) refused by the same check; quantize_dense on the card bit for bit
against the host.

Flash kernels (ops/flash_attention.py) through chip_smoke.check_flash, at
L 1000 and a ragged 517 with head widths 64, 72, 128 and 256 (the forward's
register tiles pad them to 64, 128 or 256), at dropout rates 0
and 0.1: out, lse, dq, dk, dv held to ops/flash_attention.py `agreement`
(elementwise: two bf16 steps of |plain| plus 2^-5 of the row's RMS, where
the kernels round p and ds to bf16 for their second products and the plain
versions keep fp32; lse 1e-5 relative), and each kernel fed a planted fault
(one tile skipped) refused by the same check; dq and dk/dv give the same
bits on a second call, and are refused with one split pair of their work
items left out of the merge.

gemv_int8 and gemv_bf16 (one kernel template) alone at batch 1, 3, 4 and
16 at the 5b top's products, an N % 16 == 8, a K % 16 == 10 and the 1b
top's c_attn: the residual products through chip_smoke.check_gemv (out32,
keep and res_scale), the others with the LayerNorm prologue through
chip_smoke.check_gemv_ln; the same bits on a second call, and the planted
faults (a skipped column tile; one K split left out of the combine, or of
the row statistics) refused.

LayerNorm kernels (ops/layer_norm.py) through chip_smoke.check_layer_norm
at ragged and wide shapes in fp32, bf16 and fp16 (D 7 and 12288 among
them): y, mu, rstd, dx, dg, db held to ops/layer_norm.py `agreement`
(elementwise: two steps of the output dtype of |plain| plus 1e-4 of the
tensor's RMS), the backward's same bits on a second call, and a planted
fault (the last row skipped) refused by the same check; both kernels also
on rows at a storage offset (their element path).

The Adam kernel (ops/adam.py) through chip_smoke.check_adam on a few
tensors of mixed sizes (one with a None gradient), both moment forms,
three updates: params normwise within 1e-6 of how far they moved, moments
within one fp16 step (or 1e-6 normwise in fp32), the same bits twice, and
planted faults (an update item, and in the fp16 form an amax item, of the
largest tensor left out of the walk) refused; and its walk over tensors
at a storage offset that breaks 16-byte alignment (the element path) and
over short items (many amax and update items a tensor), bit for bit
against the plain version.

The GEMVs with the LayerNorm prologue through chip_smoke.check_gemv_ln
at batch 1, 3, 4 and 16, both weight kinds.

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
from jukebox_tpu_torch.ops.core import quantize_dense

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
    for K, N, epi in ((S, 3 * A, None), (A, S, "residual"), (S, S, "gelu"),
                      (S, S, "residual")):
        w, b = rnd(K, N, scale=0.02), rnd(N, scale=0.02)
        if epi == "residual":
            x, res = rnd(B, K), rnd(B, N)
            close(ds.gemv_bf16(x, w, b, epi, res),
                  ds.gemv_bf16_plain(x, w, b, epi, res))
        else:  # the LayerNorm prologue's epilogues
            x = chip_smoke.ln_rows_in(B, K, gen, "cuda")
            ln_ = chip_smoke.ln_params(K, gen, "cuda")
            close(ds.gemv_bf16(x, w, b, epi, ln=ln_),
                  ds.ln_gemv_bf16_plain(x, w, b, ln_, epi))
    shapes = {0: (B, n_ctx, A), 1: (B, bc, A), 2: (B, bc, blocks, A),
              3: (B, 2 * bc, A), 7: (B, prime or 0, A)}
    for f in ((0, 1, 2, 3, 7) if prime else (1, 2, 3)):
        kc, vc = rnd(*shapes[f]), rnd(*shapes[f])
        for t in (0, bc - 1, bc, 2 * bc + 1, 447, 448, 2000):
            geom = ds.ring_geometry(f, t, shapes[f], bc, prime)
            qkv32 = rnd(B, 3 * A, dtype=torch.float32)
            qkv = qkv32.to(torch.bfloat16)
            k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
            close(ds.ring_attn_decode(qkv, k1, v1, geom, H, qkv32),
                  ds.ring_attn_decode_plain(qkv, k2, v2, geom, H, qkv32))
            assert torch.equal(k1, k2) and torch.equal(v1, v2)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("B", [1, 3, 4, 16])
def test_ln_gemv_matches_plain(B, kind):
    """The GEMVs with the LayerNorm prologue (ln=(g, b)) at the 1b top's
    c_attn and mlp c_fc and the 5b top's c_attn, f6 q and mlp c_fc,
    through chip_smoke.check_gemv_ln: against gemv_plain(ln_rows_plain(x))
    within 1e-2 x max(1, |plain|), the same bits on a second call, out32,
    and both planted faults (one split left out of the row statistics, the
    last column tile skipped) refused; one launch counted as
    ln_gemv_<kind> per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(8)
    rep = chip_smoke.KernelReport()
    name = f"gemv_{kind}"
    for K, N, epi in ((2048, 1536, None), (2048, 2048, "gelu"),
                      (4800, 3600, None), (4800, 1200, None),
                      (4800, 4800, "gelu")):
        w = 0.02 * torch.randn((K, N), generator=gen, device="cuda")
        b = (0.02 * torch.randn(N, generator=gen, device="cuda")).bfloat16()
        if kind == "int8":
            qd = quantize_dense({"w": w, "b": b})
            wts = (qd["w_q"], qd["s"])
        else:
            wts = (w.bfloat16(),)
        ln_ = chip_smoke.ln_params(K, gen, "cuda")
        x = chip_smoke.ln_rows_in(B, K, gen, "cuda")
        ds.reset_launches()
        chip_smoke.check_gemv_ln(rep, name, f"[{B},{K}]x[{K},{N}]", x, wts, b,
                                 epi, ln_, "cuda")
        # the check, its second call, out32 and the two planted faults
        assert ds.LAUNCHES["ln_" + name] == 5
    assert set(rep.rows) == {"ln_" + name}


@pytest.mark.gpu
def test_5b_and_int8_decode_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = {"5b top": chip_smoke.preset_shapes("prior_5b_lyrics"),
              "upsampler": chip_smoke.preset_shapes("upsampler_level_0")}
    last_t = {"5b top": 8191, "upsampler": 8191}
    rows = chip_smoke.check_kernels(shapes, 4, last_t, "cuda", gen,
                                    time_it=False)
    rows.update(chip_smoke.check_int8_kernels(shapes, 4, last_t, "cuda", gen,
                                              time_it=False))
    assert set(rows) == set(ds.LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 4, 16])
def test_split_attention_matches_plain(B):
    """The attention kernels where their rows split over blocks
    (attn_split_plan): the 1b top's f0 ring up to n_ctx rows, bf16 and
    int8, with the slot row in the last, ragged split; the 5b_lyrics top's
    f6 cross-attention over 512 and a ragged 500 encoder rows, bf16 and
    int8. Each against its plain version (1e-2 x max(1, |plain|)), the
    written rows and scales equal, the same result on a second launch (the
    combine sums the splits in a fixed order), and a planted fault (one
    split left out of the combine) refused by the same check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(4)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def int8_rows(*shape):
        q = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int32).to(torch.int8)
        return q, (torch.rand(shape[:-1], generator=gen, device="cuda")
                   * 0.02 + 0.002).to(torch.bfloat16)

    def close(out, ref):
        assert _rel_err(out.float().cpu(), ref.float().cpu()) <= 1e-2

    def refused(out, ref):
        assert _rel_err(out.float().cpu(), ref.float().cpu()) > 1e-2

    A, H, n_ctx = 512, 2, 6528
    kc, vc = rnd(B, n_ctx, A), rnd(B, n_ctx, A)
    (k8, ks), (v8, vs) = int8_rows(B, n_ctx, A), int8_rows(B, n_ctx, A)
    for t in (129, 700, 2431, n_ctx - 1):
        geom = ds.ring_geometry(0, t, (B, n_ctx, A))
        splits, chunk, _ = ds.attn_split_plan(t + 1, B, H, A // H)
        assert splits > 1 and (t // chunk) == splits - 1
        qkv32 = rnd(B, 3 * A, dtype=torch.float32)
        qkv = qkv32.to(torch.bfloat16)
        bf = [[c.clone() for c in (kc, vc)] for _ in range(3)]
        i8 = [[c.clone() for c in (k8, v8, ks, vs)] for _ in range(3)]
        out = ds.ring_attn_decode(qkv, *bf[0], geom, H, qkv32)
        close(out, ds.ring_attn_decode_plain(qkv, *bf[1], geom, H, qkv32))
        assert torch.equal(out, ds.ring_attn_decode(qkv, *bf[2], geom, H,
                                                    qkv32))
        assert all(torch.equal(a, b) for a, b in zip(bf[0], bf[1]))
        out = ds.ring_attn_int8(qkv, *i8[0], geom, H, qkv32)
        close(out, ds.ring_attn_int8_plain(qkv, *i8[1], geom, H, qkv32))
        assert torch.equal(out, ds.ring_attn_int8(qkv, *i8[2], geom, H,
                                                  qkv32))
        assert all(torch.equal(a, b) for a, b in zip(i8[0], i8[1]))
        cut = chip_smoke.dropped_split(geom, B, H, A // H, "cuda")
        for caches, kern, plain in (
                ((kc, vc), ds.ring_attn_decode, ds.ring_attn_decode_plain),
                ((k8, v8, ks, vs), ds.ring_attn_int8,
                 ds.ring_attn_int8_plain)):
            shown, dropped = chip_smoke.split_fault_caches(qkv32, caches,
                                                           *cut, A, H)
            refused(kern(qkv, *dropped, geom, H, qkv32),
                    plain(qkv, *shown, geom, H, qkv32))
    A, H = 1200, 8
    for E in (512, 500):
        q = rnd(B, A, dtype=torch.float32)
        for int8 in (False, True):
            caches = ((*int8_rows(B, E, A), *int8_rows(B, E, A)) if int8
                      else (rnd(B, E, A), rnd(B, E, A)))
            k, v = caches[0], caches[2 if int8 else 1]
            sc = (caches[1], caches[3]) if int8 else (None, None)
            out = ds.cross_attn_decode(q, k, v, H, *sc)
            close(out, ds.cross_attn_decode_plain(q, k, v, H, *sc))
            assert torch.equal(out, ds.cross_attn_decode(q, k, v, H, *sc))
            cut = chip_smoke.dropped_split((E, -1, 0, E), B, H, A // H,
                                           "cuda")
            shown, dropped = chip_smoke.split_fault_caches(
                q, (k, v, *sc) if int8 else (k, v), *cut, A, H)
            pad = [] if int8 else [None, None]
            refused(ds.cross_attn_decode(q, *dropped[:2], H, *dropped[2:],
                                         *pad),
                    ds.cross_attn_decode_plain(q, *shown[:2], H, *shown[2:],
                                               *pad))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 72, 128, 256])
def test_flash_kernels_match_plain(hd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rows = chip_smoke.check_flash(3, 1000, hd, 1, "cuda",
                                  torch.Generator(device="cuda").manual_seed(1),
                                  time_it=False, ragged=517)
    assert set(rows) == set(fa.LAUNCHES)


# the 5b_lyrics top's five products, an N % 16 == 8 and a K % 16 == 10
# (x read element by element), and the 1b_lyrics top's c_attn
GEMV_PRODUCTS = ((4800, 3600, None), (4800, 1200, None),
                 (1200, 4800, "residual"), (4800, 4800, "gelu"),
                 (4800, 4800, "residual"), (4800, 3608, None),
                 (4794, 3600, None), (2048, 1536, None))


def _check_gemvs(name, B):
    """name through chip_smoke.check_gemv at GEMV_PRODUCTS and batch B."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    rep = chip_smoke.KernelReport()
    for K, N, epi in GEMV_PRODUCTS:
        b = rnd(N, scale=0.02)
        w = rnd(K, N, dtype=torch.float32, scale=0.02)
        if name == "gemv_int8":
            qd = quantize_dense({"w": w, "b": b})
            wts = (qd["w_q"], qd["s"])
        else:
            wts = (w.to(torch.bfloat16),)
        what = f"[{B},{K}]x[{K},{N}] {epi}"
        if epi == "residual":
            chip_smoke.check_gemv(rep, name, what, rnd(B, K), wts, b, epi,
                                  rnd(B, N), "cuda")
        else:  # the LayerNorm prologue's epilogues
            chip_smoke.check_gemv_ln(
                rep, name, what, chip_smoke.ln_rows_in(B, K, gen, "cuda"),
                wts, b, epi, chip_smoke.ln_params(K, gen, "cuda"), "cuda")
    assert rep.rows[name]["max_abs_err"] >= 0.0
    assert rep.rows["ln_" + name]["max_abs_err"] >= 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 4, 16])
def test_gemv_int8_matches_plain(B):
    """gemv_int8 through chip_smoke.check_gemv at GEMV_PRODUCTS' residual
    products (out32, keep and res_scale) and check_gemv_ln at the others
    (the LayerNorm prologue; an N % 16 == 8 reads W's rows 8 bytes a
    lane): 1e-2 x max(1, |plain|), the same bits on a second call (the K
    splits summed in a fixed order), and the planted faults (the last
    column tile skipped, one K split left out of the combine or of the row
    statistics) refused."""
    _check_gemvs("gemv_int8", B)


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 3, 4, 16])
def test_gemv_bf16_matches_plain(B):
    """gemv_bf16, the same kernel template with bf16 weights, through the
    same checks at the same products."""
    _check_gemvs("gemv_bf16", B)


@pytest.mark.gpu
def test_layer_norm_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rows = chip_smoke.check_layer_norm(
        [(1000, 1000, torch.bfloat16), (517, 1920, torch.float32),
         (64, 2048, torch.float16), (3, 12288, torch.bfloat16),
         (2, 12288, torch.float32), (64, 4800, torch.bfloat16),
         (2, 7, torch.float32), (3, 7, torch.bfloat16),
         (3, 7, torch.float16)],
        "cuda", torch.Generator(device="cuda").manual_seed(2),
        time_it=False)
    assert set(rows) == set(ln.LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_layer_norm_bwd_at_a_storage_offset(dtype):
    """layer_norm_bwd on contiguous rows whose data starts one element past
    a 16-byte boundary (the backward then reads elements, not 16 bytes a
    lane), at D 2048 and D 4800: dx, dg, db within ops/layer_norm.py
    `agreement` of the plain version and the same bits on a second
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for N, D in ((300, 2048), (40, 4800)):
        x, dy = ((torch.randn(N * D + 1, generator=gen, device="cuda")
                  * 2.0 + 0.5).to(dtype)[1:].view(N, D) for _ in range(2))
        assert x.is_contiguous() and x.data_ptr() % 16
        g = 1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")
        b = 0.1 * torch.randn(D, generator=gen, device="cuda")
        _, mu, rstd = ln.layer_norm_fwd(x, g, b)
        out = ln.layer_norm_bwd(x, g, mu, rstd, dy)
        ref = ln.layer_norm_bwd_plain(x, g, mu, rstd, dy)
        assert all(ln.agreement(o, r) <= 1.0 for o, r in zip(out, ref))
        again = ln.layer_norm_bwd(x, g, mu, rstd, dy)
        assert all(torch.equal(a, o) for a, o in zip(again, out))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_layer_norm_fwd_at_a_storage_offset(dtype):
    """layer_norm_fwd on rows whose data starts one element past a 16-byte
    boundary (its element path) at D 2048 and 4800: y, mu, rstd within
    ops/layer_norm.py `agreement` of the plain version and of the
    kernel's 16-byte path on an aligned copy of the rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(7)
    for N, D in ((300, 2048), (40, 4800)):
        x = (torch.randn(N * D + 1, generator=gen, device="cuda") * 2.0
             + 0.5).to(dtype)[1:].view(N, D)
        assert x.is_contiguous() and x.data_ptr() % 16
        g = 1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")
        b = 0.1 * torch.randn(D, generator=gen, device="cuda")
        out = ln.layer_norm_fwd(x, g, b)
        ref = ln.layer_norm_fwd_plain(x, g, b)
        assert all(ln.agreement(o, r) <= 1.0 for o, r in zip(out, ref))
        assert all(ln.agreement(o, r) <= 1.0
                   for o, r in zip(out, ln.layer_norm_fwd(x.clone(), g, b)))


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


@pytest.mark.gpu
@pytest.mark.parametrize("fp16", [False, True])
def test_adam_item_order_at_a_storage_offset(fp16, monkeypatch):
    """The Adam walk over tensors whose storage starts one element past a
    16-byte boundary (every item on the element path) beside aligned ones,
    in items of 1000 elements (the fp16 form: many amax items, then update
    items in reverse, a tensor), one launch an update: params, moments and
    scales bit for bit equal to the plain version after three updates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from jukebox_tpu_torch.ops import adam as ad
    from jukebox_tpu_torch.utils import train_utils as ttu
    gen = torch.Generator(device="cuda").manual_seed(9)
    sizes = {"odd": 70001, "aligned": 5003, "small": 700}

    def tensors():
        out = {}
        for n, size in sizes.items():
            base = torch.randn(size + 1, generator=gen, device="cuda") * 0.1
            out[n] = base[1:] if n == "odd" else base[:size].clone()
        return out
    start = tensors()
    assert start["odd"].data_ptr() % 16 and start["odd"].is_contiguous()
    states = []
    for _ in range(2):
        params = {n: t.clone() if n != "odd" else
                  torch.empty(t.numel() + 1, device="cuda")[1:].copy_(t)
                  for n, t in start.items()}
        opt = ttu.adam_init(params, fp16_state=fp16)
        for k in ("m", "v"):  # the moments at the same offset
            opt[k]["odd"] = torch.zeros(70002, device="cuda", dtype=opt[k][
                "odd"].dtype)[1:]
        states.append((params, opt))
    monkeypatch.setattr(ad, "CHUNK", 1000)
    table = ad.AdamTable(*states[0])
    assert sum(kind == ad.AMAX for *_, kind in table.items) == (
        71 + 6 if fp16 else 0)
    ad.reset_launches()
    for step in range(3):
        grads = {n: torch.randn(s, generator=gen, device="cuda") * 10.0
                 for n, s in sizes.items()}
        ad.adam_update_kernel(table, grads, states[0][1], lr=1e-3,
                              beta1=0.9, beta2=0.99, eps=1e-8,
                              weight_decay=0.01, scale=2.0)
        ad.adam_update_plain(states[1][0], grads, states[1][1], lr=1e-3,
                             beta1=0.9, beta2=0.99, eps=1e-8,
                             weight_decay=0.01, scale=2.0)
    assert ad.LAUNCHES["adam_update"] == 3
    for n in sizes:
        assert torch.equal(states[0][0][n], states[1][0][n]), n
        for k in ("m", "v", "m_scale", "v_scale") if fp16 else ("m", "v"):
            assert torch.equal(states[0][1][k][n], states[1][1][k][n]), (k, n)
    assert not (table.amax.any() or table.done.any() or table.ticket.any())


@pytest.mark.gpu
def test_traced_decode_step_counts_its_launches():
    """One bf16 decode step of a staged single-enc-dec prior (width 256, 3
    layers) under torch.profiler: the recorder's launch_host.<name> calls
    (utils/profiler.py) equal the step's LAUNCHES delta, their host time
    is positive, and the step is one sample.step over one sample.layers
    and one sample.tok."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from jukebox_tpu_torch import hparams as thp
    from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
    from jukebox_tpu_torch.utils import profiler
    hps = thp.setup_hparams("teeny", dict(
        sample_length=256, levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2),
        emb_width=16, l_bins=32, width=8, depth=1, m_conv=1.0,
        dilation_growth_rate=1, sr=8000, level=2, n_ctx=24,
        prior_width=256, prior_depth=3, heads=2, blocks=4, attn_order=12,
        init_scale=0.7, min_duration=0.0, max_duration=600.0, labels=True,
        labels_v3=True, y_bins=(604, 7898), t_bins=16, max_bow_genre_size=1,
        n_vocab=79, use_tokens=True, n_tokens=8, single_enc_dec=True))
    rt = make_prior(hps, make_vqvae(hps, "cuda"), "cuda")
    m = rt.model
    rt.stage_decode()
    y = torch.from_numpy(m.get_y(m.labeller.get_batch_labels([dict(
        artist="unknown", genre="unknown", lyrics="la la la",
        total_length=8000 * 30, offset=0)] * 4), 0)).cuda()
    z = torch.randint(0, 32, (4, 9), device="cuda")
    caches, x_tok, x_cond, y_cond = m.sample_init(
        4, z=z, y=y, fp16=True, chunk_size=8, dec_params=rt.staged)
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = dict(fp16=True, dec_params=rt.staged)
    m.sample_segment(caches, x_tok, 17, 1, gen, x_cond, y_cond, **step)
    profiler.reset()
    before = profiler.counters()
    with torch.profiler.profile():
        m.sample_segment(caches, x_tok, 18, 1, gen, x_cond, y_cond, **step)
    after = profiler.counters()
    rec = profiler.traced()
    profiler.reset()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert delta and set(delta) <= set(ds.LAUNCHES)
    assert {k[len("launch_host."):]: c["calls"]
            for k, c in rec["counters"].items()} == delta
    assert all(c["ns"] > 0 for c in rec["counters"].values())
    st, = [s for s in rec["spans"] if s.name == "sample.step"]
    assert sorted(s.name for s in rec["spans"] if s.parent is st) == [
        "sample.layers", "sample.tok"]
