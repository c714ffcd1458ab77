"""Build and load the port's CUDA kernels: one plain `nvcc` call per source
into a shared library with a C interface, loaded with ctypes.

The sources are jukebox_tpu_torch/csrc/*.cu; the libraries go to
build/jukebox_tpu_torch/ under the checkout, named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import: the first kernel launch builds. nvcc is found
through CUDA_HOME, else /usr/local/cuda/bin, else PATH.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "jukebox_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_float)
# C signatures of every entry point, by source stem
SIGNATURES = {
    "decode_stack": {
        "jk_max_dyn_smem": [],
        "jk_ln_rows": [_P, _P, _P, _P, _I, _I, _F, _P],
        "jk_gemv_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "jk_ring_attn_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _F, _P],
    },
    "flash_attention": {
        "jk_flash_smem": [_I, _I],
        "jk_flash_fwd": [_P] * 5 + [_I] * 3 + [_F, _I, _U, _U, _F, _P],
        "jk_flash_dq": [_P] * 7 + [_I] * 3 + [_F, _I, _U, _U, _F, _P],
        "jk_flash_dkv": [_P] * 8 + [_I] * 3 + [_F, _I, _U, _U, _F, _P],
    },
    "layer_norm": {
        "jk_layer_norm_fwd": [_P] * 6 + [_I, _I, _F, _I, _P],
        "jk_layer_norm_bwd": [_P] * 8 + [_I] * 4 + [_P],
    },
    "adam": {
        "jk_adam_fp32": [_P] * 7 + [_I, _I, _P] + [_F] * 7 + [_P],
        "jk_adam_fp16": [_P] * 9 + [_I] * 3 + [_P, _P] + [_F] * 7 + [_P],
    },
}

_LIBS = {}
BUILD_LOG = {}  # source stem -> {"seconds", "ptxas", "cached"}


def find_nvcc():
    home = os.environ.get("CUDA_HOME")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + \
            [Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda/bin, "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _lib_path(src):
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def _compile(src, nvcc):
    out = _lib_path(src)
    if out.exists():
        return src.stem, {"seconds": 0.0, "ptxas": "", "cached": True}
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.time()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return src.stem, {"seconds": time.time() - t0, "ptxas": proc.stderr,
                      "cached": False}


def build_all():
    """Compile every csrc/*.cu (one nvcc each, all started together) and
    load them. Returns BUILD_LOG."""
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    todo = [s for s in srcs if s.stem not in _LIBS]
    if todo:
        nvcc = find_nvcc()
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            for stem, log in pool.map(lambda s: _compile(s, nvcc), todo):
                BUILD_LOG[stem] = log
        for src in todo:
            _LIBS[src.stem] = _load(src)
    return BUILD_LOG


def _load(src):
    lib = ctypes.CDLL(str(_lib_path(src)))
    for name, argtypes in SIGNATURES[src.stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def lib(stem="decode_stack"):
    """The loaded library of csrc/<stem>.cu, built on first use."""
    if stem not in _LIBS:
        build_all()
    return _LIBS[stem]


def ptxas_summary(text):
    """Per-kernel 'registers / shared memory / spill' lines of nvcc -Xptxas -v."""
    out, kernel, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d+)ELi(\d+)E)?", mangled)
            kernel = (mangled if m is None else m.group(1) if not m.group(2)
                      else f"{m.group(1)}<{m.group(2)},{m.group(3)}>")
            spill = ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            out.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {spill}")
            kernel = None
    return out
