"""The design choices of the GEMVs (gemv_bf16 and gemv_int8, one kernel
template) and of the LayerNorm kernels on one NVIDIA GPU, each timed
beside the shipped kernel: grids and load widths through the package's
own entry points, other designs from two files of alternatives
(scripts/chip_gemv_variants.cu, scripts/chip_ln_variants.cu) that the
probe builds and nothing in the package does:

    python3 scripts/chip_gemv_ln_probe.py [--reps 200] [--rounds 2]
        [--only gemv_bf16,ln_fwd,gemv_int8,ln_bwd,ln_gemv,gemv_order]

gemv_bf16 at batch 4 at the 1b_lyrics top's c_attn and c_proj, the
upsamplers' c_attn and the 5b_lyrics top's c_attn and c_proj, and
gemv_int8 at the 5b_lyrics top's five products: the shipped plan (a
cluster of K splits a column tile) and 2-16 splits through the package's
entry point (the products that take the LayerNorm prologue there through
chip_gemv_variants.cu's copy of the shipped products without it); and,
without the epilogue, from chip_gemv_variants.cu: the
design before the template (bf16), the shipped kernel with one and with
two steps in flight a lane whatever the split, the combine before the cluster (4-warp blocks,
the splits' partials through a global workspace summed by each tile's last
block: gemv_int8 as it shipped before) at two and three steps in flight,
the cluster with its partials read after the barrier, and cuts of the
shipped loop that say where its time goes (its products alone, products
and barrier, loads alone, an empty grid). Beside them addmm (gemv_int8:
on the dequantised bf16 weight).
ln_gemv: the GEMVs with the LayerNorm prologue at batch 4 at the 1b_lyrics
top's c_attn and mlp c_fc, the upsamplers' c_attn and the 5b_lyrics top's
c_attn and mlp c_fc (bf16), and the 5b top's c_attn and f6 q (int8): the
shipped LN-GEMV (the statistics met across the cluster in one exchange,
the first steps' weights in flight before them), the unfused pair it
replaced (the one-block-per-row ln_rows, then the GEMV), the statistics
read from L2 by
every block, the shipped prologue with the weight loads after it, the
statistics met in two exchanges (the mean, then the centred squares), the
weights issued before x or loaded by __ldg, every thread in the
statistics' passes (in place of a warp a row), the loop the LN-GEMV first
shipped with (each iteration's next weights issued after its products),
cuts that say where the
prologue's time goes (the prologue alone, its loads alone, the prologue
without its cluster exchange), the plain GEMV of the same product (no
LayerNorm: the shipped products without the prologue), an empty grid of
its shape, and F.layer_norm then addmm.
gemv_order: the loop order of the products without the prologue, at batch
4: the residual products of the 1b_lyrics top (c_proj, mlp.c_proj) and
the upsamplers (c_proj, mlp.c_proj) in bf16 and of the 5b_lyrics top in
int8, and the 1b top's c_attn and mlp.c_fc without their LayerNorm: the
shipped GEMV (residual products only), chip_gemv_variants.cu's copy with
each iteration's weights and x loaded before its products (the shipped
order, and gemv_bf16's before the prologue), and the copy in the
LN-GEMV's first loop order (the first steps' weights before the loop,
each iteration's next weights after its products).
layer_norm_fwd at [6528, 2048] bf16 with a block per 2, 4 (shipped) or 8
rows and with 1, 2, 3, 4, 6 and 8 blocks per SM each walking its share,
the shipped grid on the element path, the shipped loop at 2 and 8 rows a
group, a warp per row (4 and 8 blocks of 8 warps per SM), the design it
replaced (a block per row, the row staged in shared memory) and
F.layer_norm.
layer_norm_bwd at [6528, 2048] bf16 with 1, 2 (shipped), 3 and 4 blocks
per SM, the shipped grid on the element path, the kernel without the
wrapper's sum of its partials and that sum alone, the alternatives of
scripts/chip_ln_variants.cu (rows a group, prefetch, g in registers; at 2
and 3 blocks per SM, without the sum), and F.layer_norm's autograd
backward. Every variant is held to its plain version first (chip_smoke's
tolerances); times are CUDA-event means over --reps launches on inputs
rotated past the L2, in turns (a, b, ..., b, a) repeated --rounds times.
Prints the card's name and power limit; exits non-zero if a variant
disagrees.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from jukebox_tpu_torch.ops import _build  # noqa: E402
from jukebox_tpu_torch.ops import decode_stack as ds  # noqa: E402
from jukebox_tpu_torch.ops import layer_norm as ln  # noqa: E402
from jukebox_tpu_torch.ops.core import quantize_dense  # noqa: E402

VARIANTS = {}  # "gemv", "ln" -> the probe's variant library
B = 4
# gemv_int8's products: the 5b_lyrics top's five
PRODUCTS = {"c_attn": (4800, 3600, None), "f6 q": (4800, 1200, None),
            "c_proj": (1200, 4800, "residual"),
            "mlp.c_fc": (4800, 4800, "gelu"),
            "mlp.c_proj": (4800, 4800, "residual")}
# gemv_bf16's products: the 1b_lyrics top's c_attn and c_proj, the
# upsamplers' c_attn, the 5b_lyrics top's c_attn and c_proj
BF16_PRODUCTS = {"1b top c_attn": (2048, 1536, None),
                 "1b top c_proj": (512, 2048, "residual"),
                 "upsampler c_attn": (1920, 1440, None),
                 "5b top c_attn": (4800, 3600, None),
                 "5b top c_proj": (1200, 4800, "residual")}
LN_SHAPE = (6528, 2048, torch.bfloat16)


def plan_of(K, splits):
    """(splits, chunk, vec16) of K cut into about `splits` slices of a
    multiple of GEMV_STEP rows."""
    c = -(-K // splits)
    c = -(-c // ds.GEMV_STEP) * ds.GEMV_STEP
    return -(-K // c), c, 1


def old_plan(K, N, sms):
    """(splits, chunk, vec16) of the GEMV plan before the cluster: about
    four blocks of 4 warps per SM, the splits summed through a global
    workspace (the global-combine variants)."""
    tiles = -(-N // ds.GEMV_COLS)
    return plan_of(K, max(4 * sms // tiles, 1))


def build_variants():
    """The variants' libraries (each with the package's kernels of its
    source), by nvcc, both started together: {stem: ctypes library}."""
    P, I = ctypes.c_void_p, ctypes.c_int
    sig = _build.SIGNATURES["layer_norm"]
    todo = {"gemv": {"jk_probe_gemv": [I, I] + [P] * 7 + [I] * 5 + [P],
                     "jk_probe_gemv_x": [I, I] + [P] * 6 + [I] * 6 + [P],
                     "jk_probe_ln_gemv": [I, I] + [P] * 8 + [I] * 7 + [P]},
            "ln": {"jk_probe_ln_bwd": [I] + sig["jk_layer_norm_bwd"],
                   "jk_probe_ln_fwd": [I] + sig["jk_layer_norm_fwd"]}}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {k: subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
         str(_build.BUILD_DIR / f"{k}_variants.so"),
         str(ROOT / "scripts" / f"chip_{k}_variants.cu")],
        stderr=subprocess.PIPE, text=True) for k in todo}
    libs = {}
    for k, proc in procs.items():
        err = proc.communicate(timeout=600)[1]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on chip_{k}_variants.cu:\n"
                             f"{err[-4000:]}")
        for line in _build.ptxas_summary(err):
            if not line.startswith(("gemv_kernel", "attn_kernel", "ln_rows",
                                    "layer_norm_")):
                print("ptxas", line, flush=True)
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"{k}_variants.so"))
        for name, argtypes in todo[k].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        libs[k] = lib
    return libs


def gemv_x_call(order, plan, x, w, s, b, epi, res):
    """chip_gemv_variants.cu's copy of the shipped products without the
    LayerNorm prologue (x read from L2) on a given plan: order 0 each
    iteration's loads before its products, 1 the next weights after the
    products (the LN-GEMV's first loop)."""
    splits, chunk, _ = plan
    Bx, K = x.shape
    N = w.shape[1]
    y = torch.empty((Bx, N), dtype=torch.bfloat16, device=x.device)
    ds._check(VARIANTS["gemv"].jk_probe_gemv_x(
        order, int(s is not None), x.data_ptr(), w.data_ptr(), ds._ptr(s),
        b.data_ptr(), ds._ptr(res), y.data_ptr(), Bx, K, N, splits, chunk,
        ds.EPILOGUES[epi], ds._stream()), "gemv_x (probe)")
    return y


def gemv_call(name, plan, x, w, s, b, epi, res, variant=None):
    """name ("gemv_int8" or "gemv_bf16") with a given plan through the
    package's entry point (the epilogues that take the LayerNorm prologue
    there: through gemv_x_call, the same products without it), or the
    probe's variant (chip_gemv_variants.cu; no epilogue)."""
    splits, chunk, vec16 = plan
    Bx, K = x.shape
    N = w.shape[1]
    y = torch.empty((Bx, N), dtype=torch.bfloat16, device=x.device)
    if variant is None and epi not in ("residual", "res_scale"):
        return gemv_x_call(0, plan, x, w, s, b, epi, res)
    if variant is None:
        err = getattr(_build.lib(), f"jk_{name}")(
            x.data_ptr(), w.data_ptr(), ds._ptr(s), b.data_ptr(),
            ds._ptr(res), None, None, None, y.data_ptr(), None, None, Bx, K,
            N, splits, chunk, 0, ds.EPILOGUES[epi], vec16, 1.0, ds.LN_EPS,
            ds._stream())
    else:
        ws, cnt = ds.workspace("gemv probe", x.device, splits * Bx * N,
                               -(-N // ds.GEMV_COLS))
        err = VARIANTS["gemv"].jk_probe_gemv(
            variant, int(s is not None), x.data_ptr(), w.data_ptr(),
            ds._ptr(s), b.data_ptr(), y.data_ptr(), ws.data_ptr(),
            cnt.data_ptr(), Bx, K, N, splits, chunk, ds._stream())
    ds._check(err, f"{name} (probe)")
    return y


def ln_call(blocks, vec, x, g, mu, rstd, dy, summed=True, variant=None):
    """layer_norm_bwd on a given grid through the package's entry point, or
    the probe's variant kernel (see chip_ln_variants.cu)."""
    N, D = x.shape
    dx = torch.empty_like(x)
    part = torch.empty((blocks, 2, D), dtype=torch.float32, device=x.device)
    cv = ln.row_layout(D, x.element_size(), vec)[1]
    args = (x.data_ptr(), g.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), part.data_ptr(), N, D, blocks, vec,
            cv, ln.DTYPES[x.dtype], ds._stream())
    ds._check(_build.lib("layer_norm").jk_layer_norm_bwd(*args)
              if variant is None
              else VARIANTS["ln"].jk_probe_ln_bwd(variant, *args),
              "layer_norm_bwd (probe)")
    if not summed:
        return dx, part
    dgb = part.sum(dim=0)
    return dx, dgb[0], dgb[1]


def ln_fwd_call(blocks, vec, x, g, b, variant=None):
    """layer_norm_fwd on a given grid through the package's entry point, or
    the probe's variant kernel (see chip_ln_variants.cu)."""
    N, D = x.shape
    y = torch.empty_like(x)
    mu = torch.empty((N,), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mu)
    cv = ln.row_layout(D, x.element_size(), vec)[1]
    args = (x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
            mu.data_ptr(), rstd.data_ptr(), N, D, ln.EPS, blocks, vec, cv,
            ln.DTYPES[x.dtype], ds._stream())
    ds._check(_build.lib("layer_norm").jk_layer_norm_fwd(*args)
              if variant is None
              else VARIANTS["ln"].jk_probe_ln_fwd(variant, *args),
              "layer_norm_fwd (probe)")
    return y, mu, rstd


def in_turns(fns, reps, rounds):
    """{name: [us, ...]}: each fn timed over the rotated sets, in turns
    a b ... b a, `rounds` times."""
    names = list(fns)
    out = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            out[n].append(chip_smoke.device_ms(fns[n][0], fns[n][1], reps)
                          * 1e3)
    return out


def probe_gemv(name, products, args, rnd):
    """Time `name`'s shipped plan and its alternatives at `products`."""
    bf = torch.bfloat16
    sms = ds.sm_count("cuda")
    for label, (K, N, epi) in products.items():
        b = rnd(N, scale=0.02)

        def make():
            x, res = rnd(B, K), rnd(B, N) if epi == "residual" else None
            if name == "gemv_int8":
                qd = quantize_dense({"w": rnd(K, N, dtype=torch.float32,
                                              scale=0.02), "b": b})
                return x, qd["w_q"], qd["s"], b, epi, res
            return x, rnd(K, N, scale=0.02), None, b, epi, res
        sets = [make() for _ in range(chip_smoke._copies(
            K * N * (1 if name == "gemv_int8" else 2)))]
        plain = getattr(ds, f"{name}_plain")

        def reference(a):
            x, w, s_, b_, e_, r_ = a
            return plain(x, w, s_, b_, e_, r_) if s_ is not None else \
                plain(x, w, b_, e_, r_)
        tiles = -(-N // ds.GEMV_COLS)
        shipped = ds.gemv_split_plan(K, N, sms)
        plan = shipped[:2] + (1,)
        fns = {}
        # through the package's entry point, with the epilogue
        ref = reference(sets[0])
        for n in sorted({2, 4, 8, 12, 16, shipped[0]}):
            pl = plan_of(K, n)
            if pl[0] > 16:
                continue
            what = (f"{'shipped' if pl[:2] == shipped[:2] else 'plan'}: "
                    f"{pl[0]} splits ({tiles * pl[0]} blocks)")
            out = gemv_call(name, pl, *sets[0])
            e, rel = chip_smoke._err(out, ref)
            if not rel <= chip_smoke.KERNEL_TOL:
                raise SystemExit(f"{name} {label} {what}: rel {rel:.3e}")
            fns[what] = (lambda *a, pl=pl: gemv_call(name, pl, *a), sets)
        # the variants take no epilogue: the product alone
        bare = [a[:4] + (None, None) for a in sets]
        bare_ref = reference(bare[0])
        old = old_plan(K, N, sms)
        tried = [(None, "shipped, no epilogue", plan),
                 (3, "two steps in flight a lane", plan),
                 (9, "one step in flight a lane", plan),
                 (4, f"the global combine, {tiles * old[0]} blocks of 4 "
                     "warps" + (" (as shipped before)" if name == "gemv_int8"
                                else ""), old),
                 (5, "the global combine, 3 steps in flight, 3 blocks an "
                     "SM", plan_of(K, max(3 * sms // tiles, 1))),
                 (6, "the cluster, partials read after the barrier", plan),
                 (7, "shipped loop, products alone (no exchange)", plan),
                 (8, "shipped loop, products and the barrier", plan),
                 (1, "shipped loop, loads alone", plan),
                 (2, "shipped grid, empty", plan)]
        if name == "gemv_bf16":
            tried.insert(1, (0, "the design before the template", plan))
        for v, what, pl in tried:
            if v not in (1, 2, 7, 8):
                out = gemv_call(name, pl, *bare[0], variant=v)
                e, rel = chip_smoke._err(out, bare_ref)
                if not rel <= chip_smoke.KERNEL_TOL:
                    raise SystemExit(f"{name} {label} {what}: {rel:.3e}")
            fns[what] = (lambda *a, v=v, pl=pl: gemv_call(
                name, pl, *a, variant=v), bare)
        if name == "gemv_int8":  # addmm streams a dequantised weight too
            lib_sets = [(a[0], (a[1].float() * a[2]).to(bf), a[3])
                        for a in sets]
        else:
            lib_sets = [(a[0], a[1], a[3]) for a in sets]
        fns["addmm"] = (lambda x_, w_, b_: torch.addmm(b_, x_, w_), lib_sets)
        for what, ts in in_turns(fns, args.reps, args.rounds).items():
            print(f"{name} {label} [{B},{K}]x[{K},{N}] {what}: "
                  + " ".join(f"{t:.2f}" for t in ts) + " us", flush=True)
        del sets, bare, lib_sets
        torch.cuda.empty_cache()


# the LN-GEMV's products: (kind, K, N, epilogue)
LN_PRODUCTS = {"1b top c_attn": ("bf16", 2048, 1536, None),
               "1b top mlp.c_fc": ("bf16", 2048, 2048, "gelu"),
               "upsampler c_attn": ("bf16", 1920, 1440, None),
               "5b top c_attn": ("bf16", 4800, 3600, None),
               "5b top mlp.c_fc": ("bf16", 4800, 4800, "gelu"),
               "5b top c_attn int8": ("int8", 4800, 3600, None),
               "5b top f6 q int8": ("int8", 4800, 1200, None)}


def ln_variant_call(variant, x, w, s, b, epi, ln_):
    """The probe's LN-GEMV variant (chip_gemv_variants.cu
    jk_probe_ln_gemv) on the shipped plan."""
    Bx, K = x.shape
    N = w.shape[1]
    splits, chunk, _ = ds.gemv_split_plan(K, N, ds.sm_count(x.device))
    y = torch.empty((Bx, N), dtype=torch.bfloat16, device=x.device)
    u = (torch.empty_like(x) if variant == 0 else None)
    ds._check(VARIANTS["gemv"].jk_probe_ln_gemv(
        variant, int(s is not None), x.data_ptr(), w.data_ptr(), ds._ptr(s),
        b.data_ptr(), y.data_ptr(), ln_[0].data_ptr(), ln_[1].data_ptr(),
        ds._ptr(u), Bx, K, N, splits, chunk, ds.ln_pitch(chunk),
        ds.EPILOGUES[epi], ds._stream()), "ln_gemv (probe)")
    return y


def probe_ln_gemv(args, rnd, gen):
    bf = torch.bfloat16
    for label, (kind, K, N, epi) in LN_PRODUCTS.items():
        ln_ = chip_smoke.ln_params(K, gen, "cuda")
        b = rnd(N, scale=0.02)

        def make():
            x = chip_smoke.ln_rows_in(B, K, gen, "cuda")
            if kind == "int8":
                qd = quantize_dense({"w": rnd(K, N, dtype=torch.float32,
                                              scale=0.02), "b": b})
                return x, qd["w_q"], qd["s"], b, epi
            return x, rnd(K, N, scale=0.02), None, b, epi
        sets = [make() for _ in range(chip_smoke._copies(
            K * N * (1 if kind == "int8" else 2)))]
        plain = getattr(ds, f"ln_gemv_{kind}_plain")
        fn = getattr(ds, f"gemv_{kind}")

        def shipped(x, w, s_, b_, e_):
            return (fn(x, w, s_, b_, e_, ln=ln_) if s_ is not None
                    else fn(x, w, b_, e_, ln=ln_))

        plan = ds.gemv_split_plan(K, N, ds.sm_count("cuda"))[:2] + (1,)

        def bare(x, w, s_, b_, e_):
            return gemv_x_call(0, plan, x, w, s_, b_, e_, None)
        x0, w0, s0, b0, _ = sets[0]
        ref = (plain(x0, w0, s0, b0, ln_, epi) if s0 is not None
               else plain(x0, w0, b0, ln_, epi))
        fns = {"shipped LN-GEMV": (shipped, sets)}
        for v, what in ((0, "the unfused pair (ln_rows, then the GEMV)"),
                        (1, "statistics from the L2 rows in every block"),
                        (2, "shipped prologue, weight loads after it"),
                        (3, "the statistics in two exchanges, g and b read "
                            "when normalising"),
                        (4, "the weights issued before x, g and b"),
                        (5, "the weights loaded by __ldg (free to move "
                            "past the statistics)"),
                        (9, "every thread in the statistics' passes"),
                        (10, "the first loop (next weights after the "
                             "products)")):
            fns[what] = (lambda *a, v=v: ln_variant_call(v, *a[:4], a[4],
                                                         ln_), sets)
        for what, (f, _) in fns.items():
            e, rel = chip_smoke._err(f(*sets[0]), ref)
            if not rel <= chip_smoke.KERNEL_TOL:
                raise SystemExit(f"ln_gemv {label} {what}: rel {rel:.3e}")
        fns["the GEMV alone (no LayerNorm)"] = (bare, sets)
        for v, what in ((6, "the prologue alone (no weights, no products)"),
                        (7, "its loads of x, g and b alone"),
                        (8, "the prologue without its cluster exchange")):
            fns[what] = (lambda *a, v=v: ln_variant_call(v, *a[:4], a[4],
                                                         ln_), sets)
        fns["an empty grid of its shape"] = (
            lambda x_, w_, s_, b_, e_: gemv_call(
                f"gemv_{kind}", plan, x_, w_, s_, b_, None, None, variant=2),
            sets)
        if kind == "int8":
            lib_sets = [(a[0], (a[1].float() * a[2]).to(bf), a[3])
                        for a in sets]
        else:
            lib_sets = [(a[0], a[1], a[3]) for a in sets]
        fns["F.layer_norm, then addmm"] = (
            lambda x_, w_, b_: torch.addmm(b_, F.layer_norm(
                x_, (K,), ln_[0].to(bf), ln_[1].to(bf), ds.LN_EPS), w_),
            lib_sets)
        for what, ts in in_turns(fns, args.reps, args.rounds).items():
            print(f"ln_gemv {label} [{B},{K}]x[{K},{N}] {what}: "
                  + " ".join(f"{t:.2f}" for t in ts) + " us", flush=True)
        del sets, lib_sets
        torch.cuda.empty_cache()


# the loop orders' products: (kind, K, N, epilogue)
ORDER_PRODUCTS = {"1b top c_proj": ("bf16", 512, 2048, "residual"),
                  "1b top mlp.c_proj": ("bf16", 2048, 2048, "residual"),
                  "upsampler c_proj": ("bf16", 480, 1920, "residual"),
                  "upsampler mlp.c_proj": ("bf16", 1920, 1920, "residual"),
                  "5b top c_proj int8": ("int8", 1200, 4800, "residual"),
                  "5b top mlp.c_proj int8": ("int8", 4800, 4800,
                                             "residual"),
                  "1b top c_attn, no LayerNorm": ("bf16", 2048, 1536, None),
                  "1b top mlp.c_fc, no LayerNorm": ("bf16", 2048, 2048,
                                                    "gelu")}


def probe_gemv_order(args, rnd, gen):
    """The loop order of the products without the prologue (see the
    module docstring), each held to the plain version first."""
    sms = ds.sm_count("cuda")
    for label, (kind, K, N, epi) in ORDER_PRODUCTS.items():
        b = rnd(N, scale=0.02)

        def make():
            x, res = rnd(B, K), rnd(B, N) if epi == "residual" else None
            if kind == "int8":
                qd = quantize_dense({"w": rnd(K, N, dtype=torch.float32,
                                              scale=0.02), "b": b})
                return x, qd["w_q"], qd["s"], b, epi, res
            return x, rnd(K, N, scale=0.02), None, b, epi, res
        sets = [make() for _ in range(chip_smoke._copies(
            K * N * (1 if kind == "int8" else 2)))]
        plan = ds.gemv_split_plan(K, N, sms)[:2] + (1,)
        x0, w0, s0, b0, _, r0 = sets[0]
        ref = (ds.gemv_int8_plain(x0, w0, s0, b0, epi, r0) if kind == "int8"
               else ds.gemv_bf16_plain(x0, w0, b0, epi, r0))
        fns = {}
        if epi == "residual":
            fns["shipped"] = (lambda *a: gemv_call(f"gemv_{kind}", plan, *a),
                              sets)
        for order, what in ((0, "copy, each iteration's loads before its "
                                "products"),
                            (1, "copy, next weights after the products "
                                "(the LN-GEMV's first loop)")):
            fns[what] = (lambda *a, o=order: gemv_x_call(o, plan, *a), sets)
        for what, (f, _) in fns.items():
            e, rel = chip_smoke._err(f(*sets[0]), ref)
            if not rel <= chip_smoke.KERNEL_TOL:
                raise SystemExit(f"gemv_order {label} {what}: rel {rel:.3e}")
        for what, ts in in_turns(fns, args.reps, args.rounds).items():
            print(f"gemv_order {label} [{B},{K}]x[{K},{N}] {what}: "
                  + " ".join(f"{t:.2f}" for t in ts) + " us", flush=True)
        del sets
        torch.cuda.empty_cache()


def probe_ln_fwd(args, rnd, gen):
    N, D, dtype = LN_SHAPE
    item = torch.tensor([], dtype=dtype).element_size()
    sets = []
    for _ in range(chip_smoke._copies(2 * N * D * item)):
        x = (torch.randn((N, D), generator=gen, device="cuda") * 2.0
             + 0.5).to(dtype)
        g = 1.0 + 0.1 * torch.randn((D,), generator=gen, device="cuda")
        sets.append((x, g, 0.1 * torch.randn((D,), generator=gen,
                                             device="cuda")))
    ref = ln.layer_norm_fwd_plain(*sets[0])
    sms = ds.sm_count("cuda")
    rows = ln.row_layout(D, item, True)[3]
    shipped = ln.fwd_blocks(N, rows)
    fns = {}

    def add(name, fn):
        out = fn(*sets[0])
        worst = max(ln.agreement(o, r) for o, r in zip(out, ref))
        if not worst <= 1.0:
            raise SystemExit(f"layer_norm_fwd {name}: {worst:.3f} of bound")
        fns[name] = (fn, sets)
    for r in (2, rows, 8):
        add(f"one block per {r} rows ({-(-N // r)} blocks)"
            + (" (shipped)" if r == rows else ""),
            lambda *a, bl=-(-N // r): ln_fwd_call(bl, 1, *a))
    for n in (1, 2, 3, 4, 6, 8):
        add(f"{n} block{'s' * (n > 1)} per SM",
            lambda *a, bl=n * sms: ln_fwd_call(bl, 1, *a))
    add("shipped grid, element loads",
        lambda *a: ln_fwd_call(shipped, 0, *a))
    for v, what, bl in ((0, "4 rows a group (the shipped loop's copy), "
                            "4 blocks per SM", 4 * sms),
                        (1, "2 rows a group, 4 blocks per SM", 4 * sms),
                        (2, "8 rows a group, 4 blocks per SM", 4 * sms),
                        (1, "2 rows a group, a block per group", -(-N // 2)),
                        (2, "8 rows a group, a block per group", -(-N // 8)),
                        (3, "a warp per row, 4 blocks of 8 warps per SM",
                         4 * sms),
                        (3, "a warp per row, 8 blocks of 8 warps per SM",
                         8 * sms),
                        (4, "the design before (a block per row)", N)):
        add(f"variant {what}",
            lambda *a, v=v, bl=bl: ln_fwd_call(bl, 1, *a, variant=v))
    fns["F.layer_norm"] = (
        lambda x, g, b: F.layer_norm(x, (D,), g, b, ln.EPS),
        [(x, g.to(dtype), b.to(dtype)) for x, g, b in sets])
    for name, ts in in_turns(fns, args.reps // 4, args.rounds).items():
        print(f"layer_norm_fwd [{N},{D}] bf16 {name}: "
              + " ".join(f"{t:.2f}" for t in ts) + " us", flush=True)


def probe_ln_bwd(args, rnd, gen):
    N, D, dtype = LN_SHAPE
    item = torch.tensor([], dtype=dtype).element_size()
    sets = []
    for _ in range(chip_smoke._copies(3 * N * D * item)):
        x = (torch.randn((N, D), generator=gen, device="cuda") * 2.0
             + 0.5).to(dtype)
        g = 1.0 + 0.1 * torch.randn((D,), generator=gen, device="cuda")
        _, mu, rstd = ln.layer_norm_fwd_plain(x, g, torch.zeros_like(g))
        sets.append((x, g, mu, rstd, rnd(N, D, dtype=dtype)))
    ref = ln.layer_norm_bwd_plain(*sets[0])
    sms = ds.sm_count("cuda")
    fns = {}
    per_sm = ln.BWD_BLOCKS_PER_SM
    for name, blocks, vec in (
            *((f"{n} block{'s' * (n > 1)} per SM"
               + (" (shipped)" if n == per_sm else ""), n * sms, 1)
              for n in (1, 2, 3, 4)),
            ("shipped grid, element loads", per_sm * sms, 0)):
        out = ln_call(blocks, vec, *sets[0])
        worst = max(ln.agreement(o, r) for o, r in zip(out, ref))
        if not worst <= 1.0:
            raise SystemExit(f"layer_norm_bwd {name}: {worst:.3f} of bound")
        fns[name] = (lambda *a, bl=blocks, v=vec: ln_call(bl, v, *a), sets)
    fns["shipped kernel alone (partials not summed)"] = (
        lambda *a: ln_call(per_sm * sms, 1, *a, summed=False), sets)
    for v, what in ((0, "R 4, no prefetch (the shipped kernel's copy)"),
                    (1, "R 2, prefetch"), (2, "R 4, prefetch"),
                    (3, "R 8, no prefetch"), (4, "R 4, no prefetch, g in "
                                                 "registers")):
        for n_sm in (2, 3):
            out = ln_call(n_sm * sms, 1, *sets[0], variant=v)
            worst = max(ln.agreement(o, r) for o, r in zip(out, ref))
            if not worst <= 1.0:
                raise SystemExit(f"layer_norm_bwd variant {v}: {worst:.3f}")
            fns[f"variant {what}, {n_sm} blocks per SM, alone"] = (
                lambda *a, v=v, bl=n_sm * sms: ln_call(
                    bl, 1, *a, summed=False, variant=v), sets)
    part = ln_call(per_sm * sms, 1, *sets[0], summed=False)[1]
    fns["the partials' torch.sum alone"] = (lambda p: p.sum(dim=0),
                                            [(part,)])
    lib_in = [(x.detach().requires_grad_(), g.detach().requires_grad_(),
               torch.zeros_like(g).requires_grad_(), dy)
              for x, g, _, _, dy in sets[:2]]
    lib_out = [F.layer_norm(x, (D,), g.to(dtype), b.to(dtype), ln.EPS)
               for x, g, b, _ in lib_in]
    fns["F.layer_norm backward"] = (
        lambda i: torch.autograd.grad(lib_out[i], lib_in[i][:3],
                                      lib_in[i][3], retain_graph=True),
        [(0,), (1,)])
    for name, ts in in_turns(fns, args.reps // 4, args.rounds).items():
        print(f"layer_norm_bwd [{N},{D}] bf16 {name}: "
              + " ".join(f"{t:.2f}" for t in ts) + " us", flush=True)


PARTS = {"gemv_bf16": lambda args, rnd, gen: probe_gemv(
             "gemv_bf16", BF16_PRODUCTS, args, rnd),
         "ln_fwd": probe_ln_fwd,
         "gemv_int8": lambda args, rnd, gen: probe_gemv(
             "gemv_int8", PRODUCTS, args, rnd),
         "ln_bwd": probe_ln_bwd,
         "ln_gemv": probe_ln_gemv,
         "gemv_order": probe_gemv_order}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--only", default=",".join(PARTS),
                   help="comma-separated parts to run, of " + ", ".join(PARTS))
    args = p.parse_args()
    parts = args.only.split(",")
    if set(parts) - set(PARTS):
        raise SystemExit(f"unknown parts {set(parts) - set(PARTS)}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for stem, info in _build.build_all().items():
        for line in _build.ptxas_summary(info["ptxas"]):
            if "gemv" in line or "layer_norm" in line:
                print("ptxas", line, flush=True)
    VARIANTS.update(build_variants())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    for part in parts:
        PARTS[part](args, rnd, gen)


if __name__ == "__main__":
    main()
