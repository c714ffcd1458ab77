"""The port's training and decoding across real processes, on the CPU:
ranks of tests/_torch_mp_worker.py joined over gloo through the JAX
package's three variables (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
JAX_PROCESS_ID, on a free port), one thread each, the world killed if it
has not finished in 300 s. Two worlds run once per module: two ranks (the
VQ-VAE data parallel, a ZeRO-3 checkpoint, tensor-parallel decode) and
four (the prior at dp=2 x mp=2, and ZeRO-3 at dp=4). The JAX references
and the shared weights are made here.

* VQ-VAE, tests/test_multiprocess.py's check: three steps on two ranks
  (a global batch of 8, 4 rows a rank, codebook init and restarts drawn
  from the gathered batch) equal one process's: losses and gradient norms
  rtol 1e-6, every parameter's sum rtol 1e-6 (atol 1e-8), the codebooks
  of the two ranks equal bit for bit and equal to one process's within
  1e-6. One process with a placement equals the JAX step without restarts
  (test_torch_vqvae_train.py's case, through the placement's path).
* The prior of tests/test_parallel.py _build, its biases drawn nonzero,
  against the JAX single-device step on its weights and batch, at that
  test's tolerances: dp=2 x mp=2
  (Megatron split, q / k / v split by heads): loss rtol 2e-5, gn 2e-4,
  params atol 2e-5; ZeRO-3 at dp=4 (min_size 64): loss rtol 2e-6, gn
  2e-5, params atol 2e-6, and at least half of the leaves of 64 elements
  or more held at 1/4 a rank.
* A 1-head prior with a level-1 conditioner (upsampler-shaped, UP_PAR)
  at mp=2, where mp does not divide the heads (every rank runs the whole
  attention on gathered q, k, v): its step against world 1 and against
  the JAX step at the dp x mp tolerances, its fp32 tokens at top_k=1 equal
  world 1's and the JAX sampler's, its bf16 staged decode's logits on 16
  forced tokens within DECODE_TOL of world 1's, its caches whole.
* Dropout 0.1 (attention, residual, embedding) drawn for the global
  batch: the prior at dp=2 x mp=2 against one process's step with the
  same seed at the dp x mp tolerances; train.run at dp=2 with dropout and
  aug_blend against one process at the global batch, train.run's
  tolerances, its losses moved by the dropout.
* Tensor-parallel decode at mp=2: the fp32 tokens at temp 0 equal one
  process's and the JAX staged decode's; the int8-staged stream has their
  shape; the logits of the bf16 and the int8 staged decode on 16 forced
  tokens are within 1e-2 of one process's (relative to max(1, |logit|);
  they read 1e-3, and a row-split bias added on both ranks 0.15); each
  rank's caches hold half the columns.
* A checkpoint of the prior ZeRO-3 over two ranks equals one process's
  byte for byte and restores into one process (params and moments
  equal).
"""

import os
import re
import socket
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mp_worker as W
from jukebox_tpu.utils import train_utils as jtu
from jukebox_tpu_torch.models.make_models import restore_opt
from jukebox_tpu_torch.utils.convert import (flatten_tree, from_jax_params,
                                             named_leaves, vqvae_tree)

torch.set_num_threads(1)
_WORKER = os.path.join(os.path.dirname(__file__), "_torch_mp_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(world, jobs, outdir):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=_REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.pop("JUKEBOX_DIST_BACKEND", None)
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER, str(outdir), ",".join(jobs)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    return {job: [torch.load(os.path.join(outdir, f"{job}_{r}_of_{world}.pt"),
                             weights_only=False) for r in range(world)]
            for job in jobs}


def _write_wavs(d, n=2, seconds=1.0):
    for i in range(n):
        t = np.arange(int(seconds * 8000)) / 8000
        sig = 0.5 * np.sin(2 * np.pi * (200 + 100 * i) * t)
        pcm = (np.stack([sig, 0.8 * sig], axis=1) * 32767).astype("<i2")
        with wave.open(str(d / f"f{i}.wav"), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(8000)
            w.writeframes(pcm.tobytes())


# -- the JAX references and the shared weights ---------------------------------

BIAS = 0.3  # std of the biases drawn into _build's prior


def _draw_biases(params):
    """params with every bias drawn from a seed, N(0, BIAS^2): the init
    leaves them 0, and a bias of 0 hides where a row-split product's bias
    is added (once, after the all-reduce)."""
    rs = np.random.RandomState(11)

    def draw(path, leaf):
        if getattr(path[-1], "key", None) != "b":
            return leaf
        return jnp.asarray(rs.standard_normal(leaf.shape) * BIAS,
                           leaf.dtype)
    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX _build prior (its biases drawn, _draw_biases), its
    single-device step and its weights, written for the workers as
    inputs.pt (state dicts, batch, random moments)."""
    from test_parallel import _build, _run
    jprior, jstep, x, y = _build()
    jprior.params = _draw_biases(jprior.params)
    from jukebox_tpu_torch.hparams import setup_hparams
    from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tvq = make_vqvae(setup_hparams("teeny", dict(W.VQ_PAR)), "cpu")
    from_jax_params(tvq, vqvae_tree(np_tree(jprior.vqvae.params),
                                    np_tree(jprior.vqvae.state)))
    runtime = make_prior(setup_hparams("teeny", dict(W.PRIOR_PAR)), tvq,
                         "cpu")
    from_jax_params(runtime.model, np_tree(jprior.params))
    copy = lambda t: jax.tree_util.tree_map(jnp.copy, t)  # noqa: E731
    new, loss, gn = _run(jstep, copy(jprior.params),
                         jtu.adam_init(jprior.params), x, y)
    rs = np.random.RandomState(3)
    inputs = dict(vq=tvq.state_dict(), prior=runtime.model.state_dict(),
                  x=torch.from_numpy(np.array(x)),
                  y=torch.from_numpy(np.array(y)),
                  m={n: torch.from_numpy(rs.standard_normal(p.shape).astype(
                      np.float32)) for n, p in
                     runtime.model.named_parameters()},
                  v={n: torch.from_numpy(rs.uniform(0, 1, p.shape).astype(
                      np.float32)) for n, p in
                     runtime.model.named_parameters()})
    up = _build_up(jprior.vqvae, tvq)
    inputs.update(up.pop("inputs"))
    outdir = tmp_path_factory.mktemp("mp")
    torch.save(inputs, outdir / "inputs.pt")
    (outdir / "wavs").mkdir()
    _write_wavs(outdir / "wavs")
    new = named_leaves(runtime.model, np_tree(new))
    return dict(jprior=jprior, x=x, y=y, loss=loss, gn=gn, params=new,
                inputs=inputs, outdir=outdir, up=up)


def _build_up(jvq, tvq):
    """The JAX prior of W.UP_PAR on _build's VQ-VAE, its biases drawn, its
    single-device step on a batch of 4, and its tokens at top_k=1: {loss,
    gn, params (named as the port's), tokens, inputs (the port's weights,
    batch, sampling conditions and forced stream, for inputs.pt)}."""
    from jukebox_tpu.hparams import setup_hparams as jsetup
    from jukebox_tpu.models.make_models import make_prior as jmake_prior
    from jukebox_tpu.train import make_prior_train_step
    from jukebox_tpu_torch.hparams import setup_hparams
    from jukebox_tpu_torch.models.make_models import make_prior
    from test_parallel import _run
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    hps = jsetup("teeny", dict(W.UP_PAR))
    jp = jmake_prior(hps, jvq)
    jp.params = _draw_biases(jp.params)
    jstep = make_prior_train_step(jp, hps, jtu.make_lr_schedule(hps))
    bs, T = 4, W.UP_PAR["sample_length"]
    x = jax.random.uniform(jax.random.key(2), (bs, T, 1), minval=-1,
                           maxval=1)
    y = np.zeros((bs, 4 + W.UP_PAR["max_bow_genre_size"]), np.int64)
    y[:, 0], y[:, 2], y[:, 3], y[:, 4] = 600 * 8000, T, 3, 7
    copy = lambda t: jax.tree_util.tree_map(jnp.copy, t)  # noqa: E731
    new, loss, gn = _run(jstep, copy(jp.params), jtu.adam_init(jp.params),
                         x, jnp.asarray(y))
    rs = np.random.RandomState(4)
    n = 2
    z_conds = jp.get_z_conds([None, rs.randint(0, 32, (n, 16))], 0,
                             W.UP_PAR["n_ctx"])
    tokens = np.asarray(jp.sample(n, z_conds=z_conds, y=y[:n],
                                  rng=jax.random.key(7), fp16=False,
                                  temp=1.0, top_k=1, chunk_size=8))
    runtime = make_prior(setup_hparams("teeny", dict(W.UP_PAR)), tvq, "cpu")
    from_jax_params(runtime.model, np_tree(jp.params))
    return dict(loss=loss, gn=gn, tokens=tokens,
                params=named_leaves(runtime.model, np_tree(new)),
                inputs=dict(up=runtime.model.state_dict(),
                            x_up=torch.from_numpy(np.array(x)),
                            y_up=torch.from_numpy(y),
                            z_conds_up=torch.from_numpy(
                                np.asarray(z_conds[0])),
                            z_up=torch.from_numpy(rs.randint(
                                0, 32, (n, W.UP_PAR["n_ctx"])))))


@pytest.fixture(scope="module")
def world2(ref):
    return _run_world(2, ["vqvae", "ckpt", "decode", "run_mp", "run_fsdp",
                          "up_mp", "run_drop"], ref["outdir"])


@pytest.fixture(scope="module")
def world4(ref):
    return _run_world(4, ["dpmp", "fsdp", "dpmp_drop"], ref["outdir"])


# -- VQ-VAE data parallel ------------------------------------------------------

def test_vqvae_two_ranks_match_one_process(world2):
    two = world2["vqvae"]
    one = W.vqvae_steps(None)
    np.testing.assert_array_equal(two[0]["losses"], two[1]["losses"])
    np.testing.assert_array_equal(two[0]["digest"], two[1]["digest"])
    for k0, k1, k in zip(two[0]["ks"], two[1]["ks"], one["ks"]):
        np.testing.assert_array_equal(k0, k1)
        np.testing.assert_allclose(k0, k, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=1e-6)
    np.testing.assert_allclose(two[0]["gns"], one["gns"], rtol=1e-6)
    np.testing.assert_allclose(two[0]["digest"], one["digest"], rtol=1e-6,
                               atol=1e-8)


def test_vqvae_placed_world_one_matches_jax_step():
    """test_torch_vqvae_train.py's step against JAX (no restarts: every
    code in use), the port's runtime placed on a mesh of one rank."""
    import test_torch_vqvae_train as V
    from jukebox_tpu import hparams as jhp
    from jukebox_tpu import train as jtrain
    from jukebox_tpu.models import make_models as jmm
    from jukebox_tpu_torch import hparams as thp
    from jukebox_tpu_torch import train as ttrain
    from jukebox_tpu_torch.models import make_models as tmm
    from jukebox_tpu_torch.parallel.dist import make_mesh
    from jukebox_tpu_torch.parallel.placement import Placement
    from jukebox_tpu_torch.utils import train_utils as ttu
    from jukebox_tpu_torch.utils.convert import to_jax_params
    jm, params, state, tm = V._models(seed=4)
    kw = dict(lr=1e-3, lr_warmup=1.0, weight_decay=0.01, clip=1.0,
              loss_fn="lmix", train=True)
    jhps, thps = V._hps(jhp, **kw), V._hps(thp, **kw)
    jstep = jtrain.make_vqvae_train_step(jmm.VQVAERuntime(jm, params, state),
                                         jhps, jtu.make_lr_schedule(jhps))
    runtime = tmm.VQVAERuntime(tm)
    runtime.placement = Placement(tm, make_mesh(device="cpu"))
    tstep = ttrain.make_vqvae_train_step(runtime, thps,
                                         ttu.make_lr_schedule(thps))
    x = V._audio(5)
    jparams, _, jstate, jloss, jmet = jstep(
        jax.tree_util.tree_map(jnp.asarray, V._np(params)),
        jtu.adam_init(params), state, jnp.asarray(x), jax.random.key(0),
        jnp.asarray(1), 1.0)
    topt = ttu.adam_init(runtime.params)
    tloss, tmet = tstep(topt, (torch.from_numpy(x), None), 7, 1)
    assert float(tloss) == pytest.approx(float(jloss), rel=V.RTOL)
    assert float(tmet["gn"]) == pytest.approx(float(jmet["gn"]), rel=1e-4)
    V._assert_state(tm, jstate)
    jp, tp = flatten_tree(V._np(jparams)), flatten_tree(to_jax_params(tm))
    assert max(np.abs(tp[k] - jp[k]).max() for k in jp) <= 1e-2 * 1e-3


# -- the prior: dp x mp and ZeRO-3 against the JAX step ------------------------

def _assert_step(out, ref, rtol_loss, rtol_gn, atol):
    np.testing.assert_allclose(out["loss"], float(ref["loss"]),
                               rtol=rtol_loss)
    np.testing.assert_allclose(out["gn"], float(ref["gn"]), rtol=rtol_gn)
    assert out["params"].keys() == ref["params"].keys()
    for n, a in ref["params"].items():
        np.testing.assert_allclose(out["params"][n], a, rtol=0, atol=atol,
                                   err_msg=n)


def test_prior_dp2_mp2_matches_jax_step(world4, ref):
    outs = world4["dpmp"]
    for out in outs:
        _assert_step(out, ref, 2e-5, 2e-4, 2e-5)
    # the Megatron split holds half of each split product a rank
    fr = outs[0]["local_frac"]
    assert fr["prior.transformer.blocks.0.attn.c_attn.w"] == 0.5
    assert fr["prior.transformer.blocks.0.mlp.c_proj.w"] == 0.5
    assert fr["prior.transformer.blocks.0.ln_0.g"] == 1.0


def test_prior_fsdp_dp4_matches_jax_step(world4, ref):
    outs = world4["fsdp"]
    for out in outs:
        _assert_step(out, ref, 2e-6, 2e-5, 2e-6)
    big = [n for n, a in ref["params"].items() if a.size >= W.FSDP_MIN]
    quarter = [n for n in big if outs[0]["local_frac"][n] == 0.25]
    assert big and len(quarter) >= len(big) // 2, (len(quarter), len(big))


def test_fsdp_specs_of_the_workers_match_jax(world4, ref):
    """The placement's specs are the JAX fsdp_param_specs of _build's
    params, leaf for leaf."""
    from jax.sharding import PartitionSpec as P
    from jukebox_tpu.parallel.shardings import fsdp_param_specs
    specs = fsdp_param_specs(ref["jprior"].params, 4, min_size=W.FSDP_MIN)
    flat = {".".join(str(getattr(k, "key", getattr(k, "idx", ""))) for k in
                     path): tuple(s)
            for path, s in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda q: isinstance(q, P))[0]}
    port = world4["fsdp"][0]["specs"]
    assert flat.keys() == port.keys()
    for n, s in flat.items():
        assert port[n] == s + (None,) * (len(port[n]) - len(s)), n


def test_prior_dropout_dp2_mp2_matches_one_process(world4, ref):
    """Dropout drawn for the global batch: each rank's slice of rows and
    heads gets one process's masks."""
    one = W.prior_step(ref["inputs"], _mesh_one(), False,
                       seed=W.DROP_SEED, **W.DROP)
    plain = W.prior_step(ref["inputs"], _mesh_one(), False)
    assert abs(one["loss"] - plain["loss"]) > 1e-3  # the dropout is on
    for out in world4["dpmp_drop"]:
        _assert_step(out, one, 2e-5, 2e-4, 2e-5)


# -- a prior whose heads mp does not divide -----------------------------------

def test_one_head_prior_mp2_step_matches_world_one_and_jax(world2, ref):
    up = ref["up"]
    one = W.prior_step(ref["inputs"], _mesh_one(), False, "up")
    for out in world2["up_mp"]:
        _assert_step(out, up, 2e-5, 2e-4, 2e-5)
        _assert_step(out, one, 2e-5, 2e-4, 2e-5)
    # the columns of q, k, v and the rows of c_proj split, the heads not
    fr = world2["up_mp"][0]["local_frac"]
    assert fr["prior.transformer.blocks.0.attn.c_attn.w"] == 0.5
    assert fr["prior.transformer.blocks.0.attn.c_proj.w"] == 0.5


def test_one_head_prior_mp2_decode_matches_world_one_and_jax(world2, ref):
    runtime, _ = W.build_prior(ref["inputs"], "up", train=False)
    runtime.stage_decode()
    one = W.up_decode(runtime, ref["inputs"])
    np.testing.assert_array_equal(one["tokens"], ref["up"]["tokens"])
    for out in world2["up_mp"]:
        np.testing.assert_array_equal(out["tokens"], one["tokens"])
        err = (np.abs(out["logits"] - one["logits"])
               / np.maximum(1.0, np.abs(one["logits"])))
        assert err.max() <= DECODE_TOL, err.max()
        assert out["cache_cols"] == one["cache_cols"] == \
            W.UP_PAR["prior_width"] // 4


# -- tensor-parallel decode ----------------------------------------------------

DECODE_TOL = 1e-2  # the staged decode's logits, relative to max(1, |logit|)


def test_tensor_parallel_decode_tokens(world2, ref):
    jp, y = ref["jprior"], ref["y"]
    jp.stage_decode()
    jz = np.asarray(jp.sample(4, y=y, rng=jax.random.key(7), fp16=False,
                              temp=0.0, chunk_size=8))
    runtime, _ = W.build_prior(ref["inputs"])
    tz = runtime.sample(4, y=ref["inputs"]["y"], fp16=False, temp=0.0,
                        chunk_size=8).numpy()
    np.testing.assert_array_equal(tz, jz)
    runtime.stage_decode()
    logits = {"logits": W.forced_logits(runtime, ref["inputs"]["y"])}
    runtime.stage_decode(quantize="int8")
    logits["logits_int8"] = W.forced_logits(runtime, ref["inputs"]["y"])
    width = W.PRIOR_PAR["prior_width"] // 4  # m_attn 0.25
    for out in world2["decode"]:
        np.testing.assert_array_equal(out["tokens"], tz)
        assert out["tokens_int8"].shape == tz.shape
        for k, want in logits.items():
            err = np.abs(out[k] - want) / np.maximum(1.0, np.abs(want))
            assert err.max() <= DECODE_TOL, (k, err.max())
        assert out["cache_cols"] == width // 2


# -- checkpoints ---------------------------------------------------------------

def test_fsdp_checkpoint_equals_one_process_and_restores(world2, ref):
    one = W.checkpoint(ref["inputs"], _mesh_one(), ref["outdir"])
    two = world2["ckpt"]
    assert two[0]["local"] != one["local"]  # really sharded
    with open(one["path"], "rb") as f1, open(two[0]["path"], "rb") as f2:
        assert f1.read() == f2.read()
    # a world-1 run restores it
    from jukebox_tpu_torch.hparams import setup_hparams
    from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
    from jukebox_tpu_torch.utils.train_utils import adam_init
    vq = make_vqvae(setup_hparams("teeny", dict(W.VQ_PAR)), "cpu")
    runtime = make_prior(setup_hparams("teeny", dict(
        W.PRIOR_PAR, restore_prior=two[0]["path"])), vq, "cpu")
    for n, p in runtime.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      ref["inputs"]["prior"][n].numpy())
    opt, step = restore_opt(adam_init(runtime.params), two[0]["path"],
                            runtime.model)
    assert step == 7 and opt["step"] == 7
    for key in ("m", "v"):
        for n, t in opt[key].items():
            np.testing.assert_array_equal(t.numpy(),
                                          ref["inputs"][key][n].numpy())


def _mesh_one():
    from jukebox_tpu_torch.parallel.dist import make_mesh
    return make_mesh(device="cpu")


# -- train.run across ranks ----------------------------------------------------

def test_train_run_dropout_and_blend_dp2_matches_one_process(world2, ref):
    """dp=2 with dropout 0.1 and aug_blend: the global batch's masks and
    mixes for each rank's rows as the loader deals them, so one process's
    losses, gradient norms and params at bs 4."""
    from jukebox_tpu_torch.utils.checkpoints import load_checkpoint
    kw = dict(aug_blend=True, **W.DROP)
    one = W.train_run(str(ref["outdir"]), "run_drop_one", bs=4, **kw)
    plain = W.train_run(str(ref["outdir"]), "run_drop_plain", bs=4)

    def params(run):
        return flatten_tree(load_checkpoint(run["ckpt"])["params"])
    p_one, p_plain = params(one), params(plain)
    for out in world2["run_drop"]:
        np.testing.assert_allclose(out["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(out["gn"], one["gn"], rtol=1e-4)
    # the checkpoint's (EMA) params: one process's within 1e-7, while the
    # run without dropout and blend is 1e-6 or more away
    p_dp = params(world2["run_drop"][0])
    assert max(np.abs(p_dp[k] - p_one[k]).max() for k in p_one) <= 1e-7
    assert max(np.abs(p_plain[k] - p_one[k]).max() for k in p_one) > 1e-6


@pytest.mark.parametrize("job,bs", [("run_mp", 2), ("run_fsdp", 4)])
def test_train_run_across_ranks_matches_one_process(world2, ref, job, bs):
    """train.run at mesh_mp=2 (global batch bs x 2 / 2) and with fsdp at
    dp=2 (global batch 2 bs) against one process at that global batch:
    the same losses; rank 0 alone logs; the gathered checkpoint restores
    into one process."""
    outs = world2[job]
    one = W.train_run(str(ref["outdir"]), f"{job}_one", bs=bs)
    for out in outs:
        np.testing.assert_allclose(out["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(out["gn"], one["gn"], rtol=1e-4)
        assert np.isfinite(out["test"]["loss"])
    # rank 0's files, and one event file: rank 1 wrote nothing
    assert outs[0]["files"] == outs[1]["files"]
    assert [f for f in outs[0]["files"] if "tfevents" in f] != []
    assert len([f for f in outs[0]["files"] if "tfevents" in f]) == 1
    # rank 0 logs its own rows of the batch, as each JAX process logs its
    # local x_in: under fsdp at dp=2 the first half of one process's clips
    local = bs if job == "run_mp" else bs // 2

    def clip(f):
        m = re.search(r"_(\d+)_it", f)
        return int(m.group(1)) if m else -1
    assert {f for f in outs[0]["files"] if "tfevents" not in f} == {
        f for f in one["files"] if "tfevents" not in f and clip(f) < local}
    from jukebox_tpu_torch.hparams import setup_hparams
    from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
    from jukebox_tpu_torch.utils.checkpoints import load_checkpoint
    vq = make_vqvae(setup_hparams("teeny", dict(W.RUN_VQ)), "cpu")
    kw = dict(W.RUN_TOP, restore_prior=outs[0]["ckpt"], train=False)
    runtime = make_prior(setup_hparams("teeny", kw), vq, "cpu")
    ck = load_checkpoint(outs[0]["ckpt"])
    assert int(ck["step"]) == 1
    shapes = {n: tuple(p.shape) for n, p in runtime.model.named_parameters()}
    full = named_leaves(runtime.model, ck["params"])
    assert {n: a.shape for n, a in full.items()} == shapes
