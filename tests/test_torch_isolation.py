"""The port stands alone: no file of jukebox_tpu_torch/ nor chip_smoke.py
imports jax, jaxlib, jukebox_tpu or upstream's jukebox (static AST scan),
loading a checkpoint that jukebox_tpu wrote imports none of them either (a
fresh process reads one through the port's restore path), and
chip_smoke.py refuses to run without a CUDA device instead of falling back
to the CPU, also when it is copied out of the repository alone."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "jukebox_tpu", "jukebox")


def _sources():
    yield ROOT / "chip_smoke.py"
    yield from sorted((ROOT / "jukebox_tpu_torch").rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_cuda():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert "jukebox_tpu_torch" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_restoring_a_jax_checkpoint_imports_no_jax(tmp_path):
    import jax.numpy as jnp

    from jukebox_tpu.utils.checkpoints import save_checkpoint
    path = str(tmp_path / "checkpoint_latest.jkb")
    save_checkpoint(path, dict(hps={"name": "x", "bs": 1, "t": (1, 2)},
                               params={"w": jnp.ones((2, 3))}, state=None,
                               opt={"step": jnp.asarray(3, jnp.int32)},
                               step=3))
    code = (
        "import sys\n"
        "from jukebox_tpu_torch.models.make_models import load_any, "
        "resolve_restore\n"
        f"ckpt = load_any(resolve_restore({path!r}))\n"
        "assert int(ckpt['step']) == 3\n"
        "assert ckpt['params']['w'].shape == (2, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
