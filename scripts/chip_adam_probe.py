"""The design choices of the Adam kernel (jukebox_tpu_torch/csrc/adam.cu) on
one NVIDIA GPU, each timed beside the shipped walk, on the 871 parameter
tensors of the 1b_lyrics top prior (942.6 M parameters) with the
fine-tuning recipe's fp16 moments, and the fp32 form:

    python3 scripts/chip_adam_probe.py [--reps 5] [--rounds 2]

Every alternative of the walk is a list of work items (ops/adam.py
AdamTable(items=...), item_order(sizes, fp16, chunk)) and a grid handed
to the shipped kernel (walk_args: the package's jk_adam arguments with
the item length and the grid replaced), or the shipped kernel built for
other thread-steps in flight and blocks an SM
(scripts/chip_adam_variants.cu, which includes the package's source).
Compared:
  the shipped walk (ops/adam.py item_order: per tensor its amax items,
  then its update items in reverse; ad.CHUNK elements an item; the blocks
  an SM the kernel is built for); other grids; items of 2048 to 32768
  elements; the kernel built for 2 steps in flight at 2 and 3 blocks an
  SM, 1 step at 2 and 3, 4 steps at 2;
  the next tensor's amax items placed before each tensor's update items
  (interleaved: fewer blocks wait at a tensor's turn); the update items
  walking forward (no L2 reuse by order); the update items alone (one
  pass reading p, g, m16, v16 once: 20 B a parameter) and the amax items
  alone (8 B): their sum against the full walk says how much of the
  second read of g, m16, v16 the L2 served; and the kernel it replaced
  (scripts/chip_adam_variants.cu: a memset and three launches).
Each full walk is first held to the plain version on the same state, bit
for bit. Times are CUDA-event means over --reps updates, in turns (a, b,
..., b, a) repeated --rounds times; the bound is chip_smoke.adam_work's
bytes at 3.35 TB/s. Prints the card's name and power limit; exits
non-zero if a walk disagrees.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae  # noqa: E402
from jukebox_tpu_torch.ops import _build  # noqa: E402
from jukebox_tpu_torch.ops import adam as ad  # noqa: E402
from jukebox_tpu_torch.ops import decode_stack as ds  # noqa: E402
from jukebox_tpu_torch.utils import train_utils as ttu  # noqa: E402

HYPER = chip_smoke.ADAM_HYPER
OLD_CHUNK = 32768  # the replaced kernel's chunk


def build_old():
    """scripts/chip_adam_variants.cu (the shipped kernel's other builds and
    the kernel it replaced) by one nvcc."""
    out = _build.BUILD_DIR / "adam_variants.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(ROOT / "scripts" /
                                         "chip_adam_variants.cu")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on chip_adam_variants.cu:\n"
                         f"{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.jk_probe_adam_old_fp32.argtypes = [P] * 7 + [I, I, P] + [F] * 7 + [P]
    lib.jk_probe_adam_old_fp16.argtypes = ([P] * 9 + [I] * 3 + [P, P]
                                           + [F] * 7 + [P])
    lib.jk_probe_adam_old_fp32.restype = I
    lib.jk_probe_adam_old_fp16.restype = I
    lib.jk_probe_adam.argtypes = [I] + _build.SIGNATURES["adam"]["jk_adam"]
    lib.jk_probe_adam.restype = I
    return lib


# the shipped kernel's other builds: (steps in flight, blocks an SM)
BUILDS = {0: (2, 2), 1: (1, 3), 2: (2, 3), 3: (1, 2), 4: (4, 2)}


# where jk_adam (csrc/adam.cu) takes the item length and the grid
CHUNK_ARG, BLOCKS_ARG = 14, 18


def walk_args(table, grads, opt, scale, chunk, blocks):
    """jk_adam's arguments for one update of `table` (its items of `chunk`
    elements) on a grid of `blocks` blocks: ops/adam.py launch_args's with
    those two replaced."""
    args = list(ad.launch_args(table, grads, opt, scale=scale, **HYPER))
    assert args[CHUNK_ARG] == table.chunk and args[BLOCKS_ARG] <= len(
        table.items) and args[BLOCKS_ARG + 1] == int(table.fp16)
    args[CHUNK_ARG] = chunk
    args[BLOCKS_ARG] = max(1, min(blocks, len(table.items)))
    return args


def walk_update(lib, variant, table, grads, opt, scale, chunk, blocks):
    """One update of `table` in items of `chunk` elements on `blocks`
    blocks: through the package's jk_adam (variant None) or the shipped
    kernel's other build `variant` (jk_probe_adam)."""
    args = walk_args(table, grads, opt, scale, chunk, blocks)
    err = (_build.lib("adam").jk_adam(*args) if variant is None
           else lib.jk_probe_adam(variant, *args))
    ds._check(err, "adam (probe walk)")
    opt["step"] += 1


class OldAdam:
    """The replaced kernel's launches over a table's tensors: one block
    per chunk."""

    def __init__(self, lib, table):
        self.lib, self.t = lib, table
        sizes = table.dev["size"].tolist()
        chunks = [(k, s) for k, n in enumerate(sizes)
                  for s in range(0, n, OLD_CHUNK)]
        dev = table.device
        self.tensor = torch.tensor([c[0] for c in chunks],
                                   dtype=torch.int32).to(dev)
        self.start = torch.tensor([c[1] for c in chunks]).to(dev)
        self.n = len(chunks)
        self.amax = torch.empty(2 * len(sizes), device=dev)

    def __call__(self, grads, opt, scale):
        t, d = self.t, self.t.dev
        step = opt["step"] + 1
        step_size, b1, b2, c1, c2 = ad.step_scalars(
            step, HYPER["lr"], HYPER["beta1"], HYPER["beta2"])
        hyper = (scale.data_ptr(), step_size, b1, b2, c1, c2,
                 HYPER["eps"], HYPER["weight_decay"], ds._stream())
        g = t.grad_ptrs(grads)
        if t.fp16:
            err = self.lib.jk_probe_adam_old_fp16(
                d["p"].data_ptr(), g.data_ptr(), d["m"].data_ptr(),
                d["v"].data_ptr(), d["m_scale"].data_ptr(),
                d["v_scale"].data_ptr(), d["size"].data_ptr(),
                self.tensor.data_ptr(), self.start.data_ptr(), self.n,
                OLD_CHUNK, len(t.names), self.amax.data_ptr(), *hyper)
        else:
            err = self.lib.jk_probe_adam_old_fp32(
                d["p"].data_ptr(), g.data_ptr(), d["m"].data_ptr(),
                d["v"].data_ptr(), d["size"].data_ptr(),
                self.tensor.data_ptr(), self.start.data_ptr(), self.n,
                OLD_CHUNK, *hyper)
        ds._check(err, "adam (the replaced kernel)")
        opt["step"] = step


def interleaved(sizes, chunk):
    """The shipped items with each tensor's update items moved after the
    next tensor's amax items."""
    per = [[it for it in ad.item_order([n], True, chunk)] for n in sizes]
    out = []
    for k, its in enumerate(per):
        its = [(k, s, kind) for _, s, kind in its]
        amax = [it for it in its if it[2] == ad.AMAX]
        rest = [it for it in its if it[2] != ad.AMAX]
        out += amax
        out.append(rest)  # placed after the next tensor's amax items
    flat, pending = [], None
    for part in out:
        if isinstance(part, list):
            if pending is not None:
                flat += pending
            pending = part
        else:
            flat.append(part)
    return flat + (pending or [])


def forward_updates(sizes, chunk):
    """The shipped items with the update items in the amax pass's order."""
    out = []
    for k, n in enumerate(sizes):
        its = [(k, s, kind) for _, s, kind in ad.item_order([n], True, chunk)]
        out += [it for it in its if it[2] != ad.UPDATE]
        out += sorted(it for it in its if it[2] == ad.UPDATE)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for stem, info in _build.build_all().items():
        for line in _build.ptxas_summary(info["ptxas"]):
            if "adam" in line:
                print("ptxas", line, flush=True)
    old = build_old()
    hps = chip_smoke.train_hps(0)
    runtime = make_prior(hps, make_vqvae(hps, "cuda"), "cuda")
    shapes = {n: t.shape for n, t in runtime.params.items()}
    del runtime
    torch.cuda.empty_cache()
    sizes = [int(torch.Size(s).numel()) for s in shapes.values()]
    gen = torch.Generator(device="cuda").manual_seed(0)
    start = {n: 0.02 * torch.randn(s, generator=gen, device="cuda")
             for n, s in shapes.items()}
    grads = {n: torch.randn(s, generator=gen, device="cuda") * 1e3
             for n, s in shapes.items()}
    scale = torch.tensor(2.0 ** 16 * 1.7, device="cuda")
    sms = ds.sm_count("cuda")
    print(f"{len(sizes)} tensors, {sum(sizes) / 1e6:.1f} M parameters, "
          f"{sms} SMs", flush=True)

    for fp16 in (True, False):
        form = "fp16 moments" if fp16 else "fp32 moments"

        def state():
            params = {n: t.clone() for n, t in start.items()}
            return params, ttu.adam_init(params, fp16_state=fp16)
        # the plain version's update from the start, once
        ref_p, ref_o = state()
        ad.adam_update_plain(ref_p, grads, ref_o, scale=scale, **HYPER)
        per_sm = _build.lib("adam").jk_adam_blocks_per_sm()
        walks = {f"shipped ({per_sm} blocks an SM, {ad.CHUNK} elements an "
                 f"item)": dict()}
        walks.update({f"{n} blocks an SM": dict(blocks=n * sms)
                      for n in (1, 2, 3, 4) if n != per_sm})
        walks.update({f"{c} elements an item": dict(chunk=c)
                      for c in (2048, 4096, 8192, 16384, 32768)
                      if c != ad.CHUNK})
        for v, (steps, bps) in BUILDS.items():
            for c in (4096, 8192, 32768):
                walks[f"built for {steps} step(s), {bps} blocks an SM, {c} "
                      f"elements an item"] = dict(variant=v, chunk=c)
        if fp16:
            walks["interleaved (next tensor's amax first)"] = dict(
                items=interleaved(sizes, ad.CHUNK))
            walks["update items forward"] = dict(
                items=forward_updates(sizes, ad.CHUNK))
        params, opt = state()
        fns = {}
        for what, kw in walks.items():
            v = kw.get("variant")
            blocks = kw.get("blocks", (per_sm if v is None else BUILDS[v][1])
                            * sms)
            chunk = kw.get("chunk", ad.CHUNK)
            items = kw.get("items")
            if items is None:
                items = ad.item_order(sizes, fp16, chunk)
            table = ad.AdamTable(params, opt, items=items)

            def update(t, g, o, v=v, c=chunk, b=blocks):
                walk_update(old, v, t, g, o, scale, c, b)
            # held to the plain version from the start, bit for bit
            cp, co = state()
            update(ad.AdamTable(cp, co, items=items), grads, co)
            same = all(torch.equal(cp[n], ref_p[n]) and all(
                torch.equal(co[k][n], ref_o[k][n]) for k in
                (("m", "v", "m_scale", "v_scale") if fp16 else ("m", "v")))
                for n in start)
            if not same:
                raise SystemExit(f"adam {form} {what}: differs from the "
                                 f"plain version")
            del cp, co
            fns[what] = (lambda g, o, t=table, u=update: u(t, g, o),
                         [(grads, opt)])
        if fp16:  # on a state of their own: half a walk leaves it unsound
            items = ad.item_order(sizes, True)
            part_p, part_o = state()
            for what, keep in (("update items alone (20 B a parameter)",
                                (ad.UPDATE, ad.BOTH)),
                               ("amax items alone (8 B a parameter)",
                                (ad.AMAX,))):
                table = ad.AdamTable(part_p, part_o, items=[
                    it for it in items if it[2] in keep])
                fns[what] = (lambda g, o, t=table: ad.adam_update_kernel(
                    t, g, o, scale=scale, **HYPER), [(grads, part_o)])
        fns["the kernel it replaced"] = (
            lambda g, o, f=OldAdam(old, ad.AdamTable(params, opt)):
            f(g, o, scale), [(grads, opt)])
        nbytes, _ = chip_smoke.adam_work(sizes, fp16)
        print(f"adam {form}: bound {nbytes / chip_smoke.HBM_BYTES_PER_S * 1e6:.2f} "
              f"us ({nbytes / 1e9:.2f} GB)", flush=True)
        names = list(fns)
        times = {n: [] for n in names}
        for _ in range(args.rounds):
            for n in names + names[::-1]:
                times[n].append(chip_smoke.device_ms(
                    fns[n][0], fns[n][1], args.reps) * 1e3)
        for n, ts in times.items():
            print(f"adam {form} {n}: " + " ".join(f"{t:.2f}" for t in ts)
                  + " us", flush=True)
        del params, opt, ref_p, ref_o, fns
        if fp16:
            del part_p, part_o
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
