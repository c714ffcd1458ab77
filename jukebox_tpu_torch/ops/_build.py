"""Build and load the port's CUDA kernels: one plain `nvcc` call per source
into a shared library with a C interface, loaded with ctypes; and the
host-side audio readers (csrc/wavio.cpp, csrc/avio.cpp), one `g++` call
each (build_host).

The sources are jukebox_tpu_torch/csrc/*.cu and *.cpp; the libraries go to
build/jukebox_tpu_torch/ under the checkout, named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import: the first kernel launch, or the first audio
read, builds. nvcc is found through CUDA_HOME, else /usr/local/cuda/bin,
else PATH.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "jukebox_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _U, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_float, ctypes.c_int64)
# C signatures of every entry point, by source stem
SIGNATURES = {
    "decode_stack": {
        "jk_max_dyn_smem": [],
        "jk_gemv_bf16": [_P] * 11 + [_I] * 8 + [_F, _F, _P],
        "jk_gemv_int8": [_P] * 11 + [_I] * 8 + [_F, _F, _P],
        "jk_attn_decode": [_P, _I] + [_P] * 4 + [_I] + [_P] * 7 + [_I] * 9
        + [_F, _I, _P],
    },
    "flash_attention": {
        "jk_flash_smem": [_I, _I],
        "jk_flash_fwd": [_P] * 6 + [_I, _P, _P] + [_I] * 3
        + [_F, _I, _U, _U, _F, _P],
        "jk_flash_fwd_pair_floats": [_I],
        "jk_flash_bwd_pair_floats": [_I],
        "jk_flash_dq": [_P] * 8 + [_I, _P, _P] + [_I] * 3
        + [_F, _I, _U, _U, _F, _P],
        "jk_flash_dkv": [_P] * 9 + [_I, _P, _P] + [_I] * 3
        + [_F, _I, _U, _U, _F, _P],
    },
    "layer_norm": {
        "jk_layer_norm_fwd": [_P] * 6 + [_I, _I, _F] + [_I] * 4 + [_P],
        "jk_layer_norm_bwd": [_P] * 7 + [_I] * 6 + [_P],
    },
    "bias_gelu": {
        "jk_bias_gelu_fwd": [_P] * 3 + [_L] + [_I] * 5 + [_P],
        "jk_bias_gelu_bwd": [_P] * 5 + [_L] + [_I] * 5 + [_P],
    },
    "adam": {
        "jk_adam_blocks_per_sm": [],
        "jk_adam": [_P] * 12 + [_I] * 3 + [_P] * 3 + [_I, _I, _P]
        + [_F] * 7 + [_P],
    },
}

_LIBS = {}
BUILD_LOG = {}  # source stem -> {"seconds", "ptxas", "cached"}
# g++ flags of the host libraries, by source stem
HOST_FLAGS = {"wavio": [],
              "avio": ["-lavformat", "-lavcodec", "-lavutil", "-lswresample"]}


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


def _lib_path(src, flags=NVCC_FLAGS):
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_host(stem):
    """The path of csrc/<stem>.cpp built by g++ (-O3, shared, with
    HOST_FLAGS[stem]) into BUILD_DIR, building it when it is not there;
    the build writes a temporary file and renames it, so processes that
    build at once do not clash. Raises RuntimeError when g++ is missing or
    fails."""
    src = CSRC_DIR / f"{stem}.cpp"
    out = _lib_path(src, HOST_FLAGS[stem])
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {src.name} cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, "-O3", "-shared", "-fPIC", "-o", str(tmp),
                           str(src), *HOST_FLAGS[stem]],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {src.name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


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


_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def lib(stem="decode_stack"):
    """The loaded library of csrc/<stem>.cu, built on first use (once, also
    when several threads launch first)."""
    if stem not in _LIBS:
        with _BUILD_LOCK:
            if stem not in _LIBS:
                build_all()
    return _LIBS[stem]


def count(launches, key):
    """launches[key] += 1 under a lock: kernels launch from the sampling
    cascade's worker threads too, and the launch counts are checked
    exactly."""
    with _COUNT_LOCK:
        launches[key] += 1


def _template_args(s):
    """The template arguments in a mangled name's argument list s, as
    text: type names and integer values."""
    out = []
    while s:
        m = re.match(r"L[a-z](-?\d+)E", s)
        if m:
            out.append(m.group(1))
            s = s[m.end():]
            continue
        m = re.match(r"\d+", s)
        if m:
            n, j = int(m.group(0)), m.end()
            if s[j:j + n] != "_GLOBAL__N_1":
                out.append(s[j:j + n])
            s = s[j + n:]
            continue
        s = s[1:]  # N, S_, E: nesting and substitution marks
    return out


def ptxas_summary(text):
    """Per-kernel 'registers / shared memory / spill' lines of nvcc -Xptxas
    -v, each kernel named with its template arguments."""
    out, kernel, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"\d+([a-z_0-9]+_kernel)", mangled)
            kernel = mangled
            if m is not None:
                kernel = m.group(1)
                rest = mangled[m.end():]
                if rest.startswith("I") and "EEv" in rest:
                    args = _template_args(rest[1:rest.index("EEv") + 1])
                    kernel += f"<{','.join(args)}>"
            spill = ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            out.append(f"{kernel}: {line.split(':', 1)[1].strip()}; {spill}")
            kernel = None
    return out
