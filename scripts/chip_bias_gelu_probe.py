"""Time csrc/bias_gelu.cu's two kernels on the card at the 1b top's training
rows ([16 x 6528, 2048] bf16) beside variants of their row groups and grids,
each variant's outputs first held to the shipped kernel's (the forward and
dpre bit for bit, db by ops/layer_norm.py `agreement`):

    python3 scripts/chip_bias_gelu_probe.py [--rows N] [--width D]

A variant is the shipped source with kRows (rows a thread loads before
computing any, both kernels) and kBwdBlocksPerSm (the backward's register
bound) replaced, built by nvcc into build/bias_gelu_probe/ (~15 s, all at
once); the grids are the launches' own argument. Prints one line a
variant and grid, then a JSON summary line. Nothing in the package builds
these variants."""

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms  # noqa: E402
from jukebox_tpu_torch.ops import _build  # noqa: E402
from jukebox_tpu_torch.ops import bias_gelu as bg  # noqa: E402
from jukebox_tpu_torch.ops import layer_norm as ln  # noqa: E402

OUT = ROOT / "build" / "bias_gelu_probe"
# (kRows, kBwdBlocksPerSm) of each variant; the first is the shipped one
VARIANTS = [(4, 2), (4, 4), (4, 3), (2, 4), (2, 6), (8, 2), (8, 1)]


def build(rows, per_sm, nvcc):
    src = (ROOT / "jukebox_tpu_torch/csrc/bias_gelu.cu").read_text()
    src, n1 = re.subn(r"constexpr int kRows = \d+;",
                      f"constexpr int kRows = {rows};", src)
    src, n2 = re.subn(r"constexpr int kBwdBlocksPerSm = \d+;",
                      f"constexpr int kBwdBlocksPerSm = {per_sm};", src)
    assert n1 == n2 == 1, "the source's constants moved"
    cu = OUT / f"bias_gelu_r{rows}_b{per_sm}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-4000:])
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES["bias_gelu"].items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return (rows, per_sm), lib, _build.ptxas_summary(proc.stderr)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=16 * 6528)
    p.add_argument("--width", type=int, default=2048)
    args = p.parse_args()
    N, D = args.rows, args.width
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = list(pool.map(lambda v: build(*v, nvcc), VARIANTS))
    for key, _, ptx in libs:
        for line in ptx:
            print(f"ptxas r{key[0]} b{key[1]}: {line}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{torch.cuda.get_device_name(0)}; [{N},{D}] bf16; {sms} SMs",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    sets = []
    for _ in range(2):
        y = (2.0 * torch.randn((N, D), generator=gen, device=dev)
             - 0.3).bfloat16()
        do = torch.randn((N, D), generator=gen, device=dev).bfloat16()
        sets.append((y, 0.5 * torch.randn(D, generator=gen, device=dev), do))
    threads = bg.layout(D, 2, True)[1]
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(sets[0][0])
    dpre = torch.empty_like(o)
    part = torch.empty((32 * sms, D), dtype=torch.float32, device=dev)

    def fwd(lib, rows_x):
        def run(y, b, _):
            err = lib.jk_bias_gelu_fwd(y.data_ptr(), b.data_ptr(),
                                       o.data_ptr(), N, D, rows_x, 1,
                                       threads, 1, stream)
            assert err == 0, err
        return run

    def bwd(lib, rows_x):
        def run(y, b, do):
            err = lib.jk_bias_gelu_bwd(y.data_ptr(), b.data_ptr(),
                                       do.data_ptr(), dpre.data_ptr(),
                                       part.data_ptr(), N, D, rows_x, 1,
                                       threads, 1, stream)
            assert err == 0, err
            part[:rows_x].sum(dim=0)
        return run

    y, b, do = sets[0]
    want_o = bg.bias_gelu_fwd(y, b)
    want_d, _ = bg.bias_gelu_bwd(y, b, do)
    want_db = bg.bias_gelu_bwd_plain(y, b, do)[1]
    out = []
    for (rows, per_sm), lib, _ in libs:
        grids = [("fwd", g, fwd(lib, g)) for g in sorted({
            math.ceil(N / 16), math.ceil(N / 64), math.ceil(N / rows),
            8 * sms, 16 * sms})]
        grids += [("bwd", g, bwd(lib, g)) for g in sorted({
            per_sm * sms, 2 * per_sm * sms, 8 * sms})]
        for kind, g, run in grids:
            run(y, b, do)
            torch.cuda.synchronize()
            if kind == "fwd":
                same = torch.equal(o, want_o)
            else:
                same = (torch.equal(dpre, want_d) and ln.agreement(
                    part[:g].sum(dim=0), want_db) <= 1.0)
            us = device_ms(run, sets, reps=100) * 1e3
            row = dict(rows=rows, per_sm=per_sm, kind=kind, grid=g,
                       us=round(us, 2), same=same)
            print(json.dumps(row), flush=True)
            out.append(row)
    print(json.dumps({"probe": out}))


if __name__ == "__main__":
    main()
