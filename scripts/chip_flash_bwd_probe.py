"""The port's flash backward designs on one NVIDIA GPU, each beside its
alternatives, at the 1b_lyrics top prior's f0 shape [BH 2, L 6528, hd 256]:

    python3 scripts/chip_flash_bwd_probe.py [--reps 30] [--rounds 2]

scripts/chip_flash_bwd_variants.cu includes the package's kernel file
(jukebox_tpu_torch/csrc/flash_attention.cu) and adds the alternatives, so
one nvcc run builds the shipped kernels and the others into one library:

  flash_dq  shipped: one warpgroup of 64 q rows a block, K/V tiles of 64
            rows in a two-stage cp.async ring; two warpgroups (128 q rows)
            a block with 64-row tiles in one stage, or 32-row tiles (wgmma
            n32) in a two- or three-stage ring.
  flash_dkv shipped design (i): dV on warpgroup 0, dK on warpgroup 1;
            design (ii): hd as the M side, each warpgroup 128 hd rows of
            both, P and dS through shared memory.

Every variant runs its own work items (ops/flash_attention.py
_longest_first over its own tiles), is held to flash_dq_plain /
flash_dkv_plain (ops/flash_attention.py agreement) at [2, 2500, 256] with
dropout 0.1 and at the main shape, is called twice for equal bits, and is
timed at the main shape with CUDA events, in turns (a, b, ..., b, a)
repeated --rounds times.
SDPA's backward at the same shape is timed beside them. Prints the card's
name and power limit; exits non-zero if a variant disagrees or fails.
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
from jukebox_tpu_torch.ops import _build  # noqa: E402
from jukebox_tpu_torch.ops import flash_attention as fa  # noqa: E402

SRC = ROOT / "scripts" / "chip_flash_bwd_variants.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> (probe variant or None for the shipped kernel, q rows, K/V rows
# of its tiles); dq's tiles are (q, K/V), dk/dv's (K/V, q)
DQ = {"dq 64x2 1wg (shipped)": (None, 64, 64),
      "dq 64x1 2wg": (2, 128, 64),
      "dq 32x2 2wg": (0, 128, 32),
      "dq 32x3 2wg": (1, 128, 32)}
DKV = {"dkv (i) split dV / dK (shipped)": None, "dkv (ii) hd as M": 3}


def build():
    """The variants' library (the package's kernels included), by nvcc."""
    out = _build.BUILD_DIR / "flash_bwd_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(SRC)], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _build.SIGNATURES["flash_attention"].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, _I
    sig = _build.SIGNATURES["flash_attention"]
    lib.jk_probe_smem.argtypes, lib.jk_probe_smem.restype = [_I], _I
    lib.jk_probe_dq.argtypes = [_I] + sig["jk_flash_dq"]
    lib.jk_probe_dkv.argtypes = sig["jk_flash_dkv"]
    lib.jk_probe_dq.restype = lib.jk_probe_dkv.restype = _I
    for line in _build.ptxas_summary(proc.stderr):
        if "dq" in line or "dkv" in line:
            print(line, flush=True)
    for name, (var, *_) in DQ.items():
        smem = lib.jk_flash_smem(1, 256) if var is None else \
            lib.jk_probe_smem(var)
        print(f"{name}: {smem} B shared memory at hd 256", flush=True)
    print(f"dkv (i): {lib.jk_flash_smem(2, 256)} B, (ii): "
          f"{lib.jk_probe_smem(3)} B", flush=True)
    return lib


class Plan:
    """Work items (from a schedule's (items, pairs)), workspace and
    counters of one variant at one shape."""

    def __init__(self, lib, BH, L, hd, schedule):
        items, pairs = schedule
        self.items = torch.tensor(items, dtype=torch.int32, device="cuda")
        floats = max(1, pairs) * lib.jk_flash_bwd_pair_floats(hd)
        self.ws = torch.empty(floats, dtype=torch.float32, device="cuda")
        self.cnt = torch.zeros(max(1, pairs), dtype=torch.int32,
                               device="cuda")
        self.shape = (BH, L, hd)

    def args(self):
        return (self.items.data_ptr(), self.items.shape[0],
                self.ws.data_ptr(), self.cnt.data_ptr(), *self.shape)


def runner(lib, kind, var, BH, L, hd, tiles=None):
    """fn(q, k, v, g, lse, dd, scale, rate, seed) -> dq or (dk, dv) through
    the given variant of the library."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = Plan(lib, BH, L, hd, (
        fa._longest_first(BH, fa._q_ranges(L, *tiles), sms) if kind == "dq"
        else fa.dkv_schedule(BH, L, sms)))
    stream = torch.cuda.current_stream().cuda_stream

    def run(q, k, v, g, lse, dd, scale, rate=0.0, seed=0):
        ptrs = [t.data_ptr() for t in (q, k, v, g, lse, dd)]
        drop = fa._dropout_args(rate, seed)
        if kind == "dq":
            out = torch.empty_like(q)
            fn = (lib.jk_flash_dq if var is None
                  else lambda *a: lib.jk_probe_dq(var, *a))
            rc = fn(*ptrs, out.data_ptr(), *plan.args(), scale, *drop, stream)
        else:
            out = (torch.empty_like(k), torch.empty_like(v))
            fn = lib.jk_flash_dkv if var is None else lib.jk_probe_dkv
            rc = fn(*ptrs, out[0].data_ptr(), out[1].data_ptr(), *plan.args(),
                    scale, *drop, stream)
        if rc:
            raise RuntimeError(f"{kind} variant {var}: CUDA error {rc}")
        return out
    return run


def device_us(fn, reps):
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))  # queue the timed calls behind device work
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def inputs(gen, BH, L, hd, rate, seed):
    q, k, v, g = (torch.randn((BH, L, hd), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    scale = hd ** -0.5
    out, lse = fa.flash_fwd_plain(q, k, v, scale, rate, seed)
    dd = (g.float() * out.float()).sum(-1)
    return (q, k, v, g, lse, dd, scale, rate, seed)


def check(name, run, args, ref):
    a, b = run(*args), run(*args)
    if isinstance(ref, tuple):
        worst = max(fa.agreement(x, r) for x, r in zip(a, ref))
        same = all(torch.equal(x, y) for x, y in zip(a, b))
    else:
        worst, same = fa.agreement(a, ref), torch.equal(a, b)
    BH, L, hd = args[0].shape
    print(f"{name} [{BH},{L},{hd}] rate {args[7]}: {worst:.3f} of the "
          f"bound, same bits {same}", flush=True)
    return worst <= 1.0 and same


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=2)
    opts = ap.parse_args()
    reps = opts.reps
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok, runs = True, {}
    for BH, L, rate in ((2, 2500, 0.1), (2, 6528, 0.0)):
        args = inputs(gen, BH, L, 256, rate, 3)
        ref_dq, ref_dkv = fa.flash_dq_plain(*args), fa.flash_dkv_plain(*args)
        for name, (var, bq, bkv) in DQ.items():
            run = runner(lib, "dq", var, BH, L, 256, (bq, bkv))
            ok &= check(name, run, args, ref_dq)
            runs[name] = run
        for name, var in DKV.items():
            run = runner(lib, "dkv", var, BH, L, 256)
            ok &= check(name, run, args, ref_dkv)
            runs[name] = run
    # runs now hold the main shape's plans; time them there without dropout
    args = args[:7]
    for group in (DQ, DKV):
        times = {name: [] for name in group}
        for name in (list(group) + list(group)[::-1]) * opts.rounds:
            times[name].append(device_us(lambda: runs[name](*args), reps))
        for name, t in times.items():
            print(f"{name} [2,6528,256]: "
                  + " / ".join(f"{x:.2f}" for x in t) + " us", flush=True)
    q, k, v, g = args[:4]
    lq = [x.reshape(1, 2, 6528, 256).detach().requires_grad_()
          for x in (q, k, v)]
    lo = F.scaled_dot_product_attention(*lq, is_causal=True)
    lg = g.reshape(1, 2, 6528, 256)
    sdpa_us = device_us(
        lambda: torch.autograd.grad(lo, lq, lg, retain_graph=True), reps)
    print(f"SDPA backward (dq, dk, dv together) [2,6528,256]: {sdpa_us:.2f} "
          f"us", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if not ok:
        raise SystemExit("a variant disagrees with its plain version")


if __name__ == "__main__":
    main()
