"""The design choices of gemv_int8 and layer_norm_bwd on one NVIDIA GPU,
each timed beside the shipped kernel: grids and load widths through the
package's own entry points, other designs from two files of alternatives
(scripts/chip_gemv_variants.cu, scripts/chip_ln_variants.cu) that the
probe builds and nothing in the package does:

    python3 scripts/chip_gemv_ln_probe.py [--reps 200] [--rounds 2]

gemv_int8 at the 5b_lyrics top's five products, batch 4, with K cut into
half the splits of the shipped gemv_split_plan, the shipped plan, and
twice its splits; and the shipped plan with W read 8 bytes a lane
instead of 16. Beside them addmm on the dequantised bf16 weight. At
every product, without its epilogue, also scripts/chip_gemv_variants.cu
(each variants file is one nvcc run, both started together): the other
design the redesign measured (each block's slice streamed through a
cp.async ring of stages in shared memory), the shipped kernel with 3 or 4
steps in flight a warp at 3 blocks an SM, and two cuts of the shipped
kernel that say where its time goes: its loads alone and its grid with no
work; and a product of c_attn's bytes whose K (384) takes one split a
tile, so the shipped plan has no combine and half its splits the same.
layer_norm_bwd at [6528, 2048] bf16 with 1, 2 (shipped), 3 and 4 blocks
per SM, the shipped grid on the element path, the kernel without the
wrapper's sum of its partials and that sum alone, the alternatives of
scripts/chip_ln_variants.cu (rows a group, prefetch, g in registers; at 2
and 3 blocks per SM, without the sum), and F.layer_norm's autograd
backward. Every variant is held
to its plain version first (chip_smoke's tolerances); times are CUDA-event
means over --reps launches on inputs rotated past the L2, in turns (a, b,
..., b, a) repeated --rounds times. Prints the card's name and power
limit; exits non-zero if a variant disagrees.
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
PRODUCTS = {"c_attn": (4800, 3600, None), "f6 q": (4800, 1200, None),
            "c_proj": (1200, 4800, "residual"),
            "mlp.c_fc": (4800, 4800, "gelu"),
            "mlp.c_proj": (4800, 4800, "residual"),
            # c_attn's bytes in one split a tile: no combine (its 2x splits
            # variant: two splits, the smallest combine)
            "c_attn's bytes, K 384": (384, 45056, None)}
LN_SHAPE = (6528, 2048, torch.bfloat16)


def gemv_variants(K, N):
    """name -> (splits, chunk, vec16) of each launch plan tried."""
    splits, chunk, _, tiles = ds.gemv_split_plan(B, K, N, ds.sm_count("cuda"))

    def cut(n):
        c = -(-K // n)
        c = -(-c // ds.GEMV_STEP) * ds.GEMV_STEP
        return -(-K // c), c
    half, double = cut(max(1, splits // 2)), cut(2 * splits)
    return {f"half the splits ({tiles * half[0]} blocks)": (*half, 1),
            f"shipped ({tiles * splits} blocks)": (splits, chunk, 1),
            f"2x splits ({tiles * double[0]} blocks)": (*double, 1),
            "shipped, 8-byte loads": (splits, chunk, 0)}


def build_variants():
    """The variants' libraries (each with the package's kernels of its
    source), by nvcc, both started together: {stem: ctypes library}."""
    todo = {"gemv": ("jk_probe_gemv", ("decode_stack", "jk_gemv_int8")),
            "ln": ("jk_probe_ln_bwd", ("layer_norm", "jk_layer_norm_bwd"))}
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
            if "regs" in line or "stream" in line or "variant" in line:
                print("ptxas", line, flush=True)
        lib = ctypes.CDLL(str(_build.BUILD_DIR / f"{k}_variants.so"))
        name, (stem, entry) = todo[k]
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] + _build.SIGNATURES[stem][entry]
        fn.restype = ctypes.c_int
        libs[k] = lib
    return libs


def gemv_call(plan, x, wq, s, b, epi, res, variant=None):
    """gemv_int8 with a given plan through the package's entry point, or
    (variant: 0 registers, 1 prologue only, 2 empty) the probe's."""
    splits, chunk, vec16 = plan
    Bx, K = x.shape
    N = wq.shape[1]
    y = torch.empty((Bx, N), dtype=torch.bfloat16, device=x.device)
    ws, cnt = ds.workspace("gemv", x.device, splits * Bx * N,
                           -(-N // ds.GEMV_COLS))
    args = (x.data_ptr(), wq.data_ptr(), s.data_ptr(), b.data_ptr(),
            ds._ptr(res), None, None, None, y.data_ptr(), ws.data_ptr(),
            cnt.data_ptr(), Bx, K, N, splits, chunk, ds.EPILOGUES[epi],
            vec16, 1.0, ds._stream())
    err = (_build.lib().jk_gemv_int8(*args) if variant is None
           else VARIANTS["gemv"].jk_probe_gemv(variant, *args))
    ds._check(err, "gemv_int8 (probe)")
    return y


def ln_call(blocks, vec, x, g, mu, rstd, dy, summed=True, variant=None):
    """layer_norm_bwd on a given grid through the package's entry point, or
    the probe's variant kernel (see chip_ln_variants.cu)."""
    N, D = x.shape
    dx = torch.empty_like(x)
    part = torch.empty((blocks, 2, D), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), g.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), part.data_ptr(), N, D, blocks, vec,
            ln.DTYPES[x.dtype], ds._stream())
    ds._check(_build.lib("layer_norm").jk_layer_norm_bwd(*args)
              if variant is None
              else VARIANTS["ln"].jk_probe_ln_bwd(variant, *args),
              "layer_norm_bwd (probe)")
    if not summed:
        return dx, part
    dgb = part.sum(dim=0)
    return dx, dgb[0], dgb[1]


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


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=200)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for stem, info in _build.build_all().items():
        for line in _build.ptxas_summary(info["ptxas"]):
            if "gemv_int8" in line or "layer_norm_bwd" in line:
                print("ptxas", line, flush=True)
    VARIANTS.update(build_variants())
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    for label, (K, N, epi) in PRODUCTS.items():
        b = rnd(N, scale=0.02)

        def make():
            qd = quantize_dense({"w": rnd(K, N, dtype=torch.float32,
                                          scale=0.02), "b": b})
            return (rnd(B, K), qd["w_q"], qd["s"], b, epi,
                    rnd(B, N) if epi == "residual" else None)
        sets = [make() for _ in range(chip_smoke._copies(K * N))]
        ref = ds.gemv_int8_plain(*sets[0])
        fns = {}
        for name, plan in gemv_variants(K, N).items():
            out = gemv_call(plan, *sets[0])
            e, rel = chip_smoke._err(out, ref)
            if not rel <= chip_smoke.KERNEL_TOL:
                raise SystemExit(f"gemv_int8 {label} {name}: rel {rel:.3e}")
            fns[name] = (lambda *a, plan=plan: gemv_call(plan, *a), sets)
        plan = ds.gemv_split_plan(B, K, N, ds.sm_count("cuda"))[:2] + (1,)
        # the probe's kernels take no epilogue: they run the product alone
        # (timed on the same sets; the epilogue is a few stores a column)
        bare = [a[:4] + (None, None) for a in sets]
        bare_ref = ds.gemv_int8_plain(*bare[0])
        # 3 or 4 steps in flight a warp at 3 blocks an SM, on the plan for
        # 3 blocks an SM
        plan3 = ds.gemv_split_plan(B, K, N, ds.sm_count("cuda") * 3
                                   // ds.GEMV_WAVES)[:2] + (1,)
        for v, name, pl in (
                (None, "shipped, no epilogue", plan),
                (0, "cp.async ring in shared memory", plan),
                (1, "shipped loads alone", plan),
                (2, "shipped grid, empty", plan),
                (3, "4 steps in flight, 3 blocks an SM "
                    f"({-(-N // ds.GEMV_COLS) * plan3[0]} blocks)", plan3),
                (4, "3 steps in flight, 3 blocks an SM "
                    f"({-(-N // ds.GEMV_COLS) * plan3[0]} blocks)", plan3)):
            if v == 0 and pl[1] > 768:  # the ring's x rows must fit
                continue
            if v in (0, 3, 4):
                out = gemv_call(pl, *bare[0], variant=v)
                e, rel = chip_smoke._err(out, bare_ref)
                if not rel <= chip_smoke.KERNEL_TOL:
                    raise SystemExit(f"gemv_int8 {label} {name}: {rel:.3e}")
            fns[name] = (lambda *a, v=v, pl=pl: gemv_call(pl, *a, variant=v),
                         bare)
        fns["addmm (dequantised bf16 W)"] = (
            lambda x_, w_, b_: torch.addmm(b_, x_, w_),
            [(a[0], (a[1].float() * a[2]).to(bf), a[3]) for a in sets])
        for name, ts in in_turns(fns, args.reps, args.rounds).items():
            print(f"gemv_int8 {label} [{B},{K}]x[{K},{N}] {name}: "
                  + " ".join(f"{t:.2f}" for t in ts) + " us", flush=True)
        del sets
        torch.cuda.empty_cache()

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


if __name__ == "__main__":
    main()
