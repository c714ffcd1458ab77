"""Rehearsal of chip_smoke.py on the CPU at toy size: its kernel checks, the
decode-step check and the cascade with its launch accounting run through
the same functions as on the card, with the wrappers' plain versions (CPU
tensors). The expected per-kernel launch counts that the card run holds
the kernels' counters to must equal the number of plain-version calls the
cascade makes here, for the decode kernels and the LayerNorm kernels; the
same holds for the training phases (flash, LayerNorm, Adam), including the
save at step 1 and the run restored from that checkpoint. Phase 4 runs the
sequential scheduler with the inline finalize and phase 4c's cascade the
default one (pipelined, the finalize and staging on worker threads; so do
phases 4b and 7): both give the same codes here; phase 4c's upstream
files (save_upstream) restore bit for bit, and the writer itself is held
to the JAX package's converter in tests/test_torch_upstream.py; phase
4d's golden dump runs on presets cut to narrow widths."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jukebox_tpu_torch.hparams import Hyperparams, setup_hparams
from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
from jukebox_tpu_torch.ops import decode_stack as ds

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
VQ = dict(sample_length=512, levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2),
          emb_width=16, l_bins=32, width=8, depth=1, m_conv=1.0,
          dilation_growth_rate=1, sr=8000)
UP = dict(n_ctx=64, prior_width=32, prior_depth=3, heads=1, attn_order=2,
          blocks=8, init_scale=0.4, cond_width=16, cond_depth=1,
          cond_dilation_growth_rate=1, cond_dilation_cycle=None,
          use_tokens=False, labels=True, y_bins=(120, 4111), t_bins=16,
          max_bow_genre_size=5, n_vocab=80, min_duration=0.0,
          max_duration=600.0, sr=8000)
# order 12 at depth 48: f7 prime layers and the f0 dense layer, like the
# 1b_lyrics top; 24 lyric tokens + 96 codes = 120 = 8 blocks of 15
TOP = dict(level=2, n_ctx=96, prior_width=32, prior_depth=48, heads=2,
           attn_order=12, blocks=8, init_scale=0.2, labels=True,
           labels_v3=True, y_bins=(604, 7898), t_bins=16,
           max_bow_genre_size=1, n_vocab=79, min_duration=0.0,
           max_duration=600.0, use_tokens=True, n_tokens=24,
           prime_loss_fraction=0.4, single_enc_dec=True, sr=8000)


@pytest.fixture(scope="module")
def priors():
    vq = make_vqvae(setup_hparams("teeny", dict(VQ)), "cpu")
    return [make_prior(setup_hparams("teeny", dict(UP, level=0)), vq, "cpu"),
            make_prior(setup_hparams("teeny", dict(UP, level=1)), vq, "cpu"),
            make_prior(setup_hparams("teeny", dict(TOP)), vq, "cpu")]


# the 5b_lyrics layout cut to size: an order-10 top of 20 layers (the f6
# layer at 18) with 4 heads of width 6, merged_decoder, and a 2-layer lyric
# encoder over 8 lyric tokens; the order-2 upsamplers of UP
TOP5 = dict(level=2, n_ctx=64, prior_width=96, prior_depth=20, heads=4,
            attn_order=10, blocks=8, init_scale=0.2, labels=True,
            y_bins=(120, 4111), t_bins=16, max_bow_genre_size=5, n_vocab=80,
            min_duration=0.0, max_duration=600.0, use_tokens=True,
            n_tokens=8, prime_width=32, prime_depth=2, prime_heads=2,
            prime_attn_order=2, prime_blocks=4, prime_init_scale=0.7,
            prime_loss_fraction=0.4, merged_decoder=True, sr=8000)


@pytest.fixture(scope="module")
def priors5():
    vq = make_vqvae(setup_hparams("teeny", dict(VQ)), "cpu")
    return [make_prior(setup_hparams("teeny", dict(UP, level=0)), vq, "cpu"),
            make_prior(setup_hparams("teeny", dict(UP, level=1)), vq, "cpu"),
            make_prior(setup_hparams("teeny", dict(TOP5)), vq, "cpu")]


def test_kernel_checks(priors, priors5):
    top, ups = priors[-1], priors[0]
    shapes = {"top": chip_smoke.prior_shapes(top),
              "upsampler": chip_smoke.prior_shapes(ups)}
    assert shapes["top"]["funcs"] == [0, 1, 2, 3, 7]
    assert shapes["top"]["prime"] == 32 and shapes["top"]["bc"] == 15
    shapes["5b top"] = chip_smoke.prior_shapes(priors5[-1])
    shapes["5b top"]["enc"] = priors5[-1].n_tokens
    assert shapes["5b top"]["funcs"] == [1, 2, 3, 6]
    last_t = {"top": 24 + 512 // top.raw_to_tokens - 1, "upsampler": 63,
              "5b top": 63}
    gen = torch.Generator().manual_seed(0)
    rows = chip_smoke.check_kernels(shapes, 2, last_t, "cpu", gen,
                                    time_it=False)
    rows.update(chip_smoke.check_int8_kernels(shapes, 2, last_t, "cpu", gen,
                                              time_it=False))
    assert set(rows) == set(ds.LAUNCHES)
    assert all(r["max_abs_err"] == 0.0 for r in rows.values())


def test_stack_step_check(priors):
    for prior in (priors[-1], priors[0]):
        chip_smoke.check_stack_step(prior, 2, "cpu",
                                    torch.Generator().manual_seed(1))


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_5b_stack_step_check(priors5, quantize):
    for prior in (priors5[-1], priors5[0]):
        chip_smoke.check_stack_step(prior, 2, "cpu",
                                    torch.Generator().manual_seed(1),
                                    quantize)


def test_5b_int8_cascade_launch_accounting(priors5, tmp_path, monkeypatch):
    """Phase 7's accounting: the int8 cascade of the 5b-like family, every
    decode kernel's plain calls (f6 cross-attention included) and the
    LayerNorm calls (the lyric encoder's forward, the conditioners) equal
    their expected counts."""
    from jukebox_tpu_torch.ops import layer_norm as ln
    calls = _count_plain(monkeypatch, ds, ds.LAUNCHES)
    ln_calls = _count_plain(monkeypatch, ln, ln.LAUNCHES)
    hps = Hyperparams(n_samples=2, sample_length=VQ["sample_length"],
                      sr=VQ["sr"], hop_fraction=(1.0, 1.0, 0.125), seed=0,
                      name=str(tmp_path / "smoke5"))
    skw = [dict(temp=0.99, fp16=True, chunk_size=32, max_batch_size=2)
           for _ in priors5]
    rep = chip_smoke.run_cascade(priors5, hps, skw, int8=True)
    assert rep["steps"] == [128, 64, 32]
    # 32 top steps x (19 ring + 1 cross); 192 upsampler steps x 3 layers
    assert rep["expected"]["cross_attn_decode"] == 32
    assert rep["expected"]["ring_attn_int8"] == 32 * 19 + 192 * 3
    # two GEMVs a layer with the LayerNorm prologue, two without
    assert rep["expected"]["gemv_int8"] == rep["expected"][
        "ln_gemv_int8"] == 2 * (32 * 20 + 192 * 3)
    assert rep["expected"]["gemv_bf16"] == rep["expected"][
        "ln_gemv_bf16"] == rep["expected"]["ring_attn_decode"] == 0
    assert calls == rep["expected"]
    # conditioners: 2 + 1 windows; the lyric encoder: 2 x 2 layers + 1
    assert rep["ln_expected"]["layer_norm_fwd"] == 3 + 5
    assert ln_calls == rep["ln_expected"]
    assert rep["launches"] == dict.fromkeys(ds.LAUNCHES, 0)


def test_cascade_launch_accounting(priors, tmp_path, monkeypatch):
    calls = dict.fromkeys(ds.LAUNCHES, 0)
    for name in calls:
        plain = getattr(ds, name + "_plain")

        def counted(*a, _name=name, _plain=plain, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(ds, name + "_plain", counted)
    hps = Hyperparams(n_samples=2, sample_length=VQ["sample_length"],
                      sr=VQ["sr"], hop_fraction=(1.0, 1.0, 0.125), seed=0,
                      name=str(tmp_path / "smoke"))
    skw = [dict(temp=0.99, fp16=True, chunk_size=32, max_batch_size=2)
           for _ in priors]
    rep = chip_smoke.run_cascade(priors, hps, skw)
    # top: 32 codes plus the whole 24-token lyric prefix decoded token by
    # token (the 2-block prefill chunk, 30 tokens, is longer than it)
    assert rep["steps"] == [128, 64, 32 + 24]
    assert calls == rep["expected"]
    assert rep["launches"] == dict.fromkeys(ds.LAUNCHES, 0)  # CPU: no kernel
    for level, lv in rep["levels"].items():
        assert lv["tokens"] == VQ["sample_length"] // priors[level].raw_to_tokens


def test_schedulers_give_phase_4s_codes(tmp_path, monkeypatch):
    """Phase 4 (sequential=True: pipeline_cascade=False and the inline
    finalize) and phase 4c's cascade (the default scheduler: pipelined,
    finalize and staging on worker threads) sample the same codes, and
    each run's plain calls of the decode kernels equal its expected
    counts."""
    vq = make_vqvae(setup_hparams("teeny", dict(VQ)), "cpu")
    priors = [make_prior(setup_hparams("teeny", dict(UP, level=0)), vq, "cpu"),
              make_prior(setup_hparams("teeny", dict(UP, level=1)), vq, "cpu"),
              make_prior(setup_hparams("teeny", dict(TOP)), vq, "cpu")]
    calls = _count_plain(monkeypatch, ds, ds.LAUNCHES)
    reps = []
    for sequential in (True, False):
        for k in calls:
            calls[k] = 0
        hps = Hyperparams(n_samples=2, sample_length=VQ["sample_length"],
                          sr=VQ["sr"], hop_fraction=(0.5, 0.5, 0.125),
                          seed=0, name=str(tmp_path / str(sequential)))
        skw = [dict(temp=0.99, fp16=True, chunk_size=16, max_batch_size=2)
               for _ in priors]
        rep = chip_smoke.run_cascade(priors, hps, skw, sequential=sequential)
        assert calls == rep["expected"]
        reps.append(rep)
    assert [r["scheduler"] for r in reps] == ["sequential", "pipelined"]
    for a, b in zip(reps[0]["zs"], reps[1]["zs"]):
        np.testing.assert_array_equal(a, b)


def test_upstream_round_trip(tmp_path):
    """Phase 4c's files at toy size: after round_dense_fp16, each model
    written by save_upstream (the priors' dense weights in fp16, the top's
    keys under "module.") restores through make_vqvae / make_prior bit for
    bit, with the file's step (assert_same_model; the writer itself is
    held to the JAX package's converter in tests/test_torch_upstream.py)."""
    from jukebox_tpu_torch.utils.torch_convert import load_state
    vq = make_vqvae(setup_hparams("teeny", dict(VQ)), "cpu")
    cfgs = [dict(UP, level=0), dict(UP, level=1), dict(TOP)]
    priors = [make_prior(setup_hparams("teeny", dict(c)), vq, "cpu")
              for c in cfgs]
    assert chip_smoke.round_dense_fp16(priors) == sum(
        2 * p.model.prior.transformer.n_depth * 2 for p in priors)
    path = str(tmp_path / "vqvae.pth.tar")
    chip_smoke.save_upstream(path, vq, dict(VQ), step=100)
    vq2 = make_vqvae(setup_hparams("teeny", dict(VQ, restore_vqvae=path,
                                                 seed=1)), "cpu")
    assert vq2.step == 100
    n = chip_smoke.assert_same_model(vq2, vq, "vqvae")
    for level, (p, c) in enumerate(zip(priors, cfgs)):
        path = str(tmp_path / f"prior_level_{level}.pth.tar")
        dtypes = chip_smoke.save_upstream(
            path, p.model, c, step=101 + level, fp16=True,
            prefix="module." if level == 2 else "")
        assert set(dtypes) == {"torch.float16", "torch.float32"}
        keys = list(load_state(path)["model"])
        assert all(k.startswith("module.") == (level == 2) for k in keys)
        p2 = make_prior(setup_hparams("teeny", dict(c, restore_prior=path,
                                                    seed=1)), vq2, "cpu")
        assert p2.step == 101 + level
        n += chip_smoke.assert_same_model(p2.model, p.model, f"{level}")
    assert n == sum(len(list(m.parameters()))
                    for m in [vq] + [p.model for p in priors])


def test_golden_phase(monkeypatch):
    """Phase 4d on presets cut to narrow widths and two layers at their own
    n_ctx (the dump hard-wires 6144 codes and 384 lyric tokens): the
    dump's shapes and finite values as the card run checks them."""
    from jukebox_tpu_torch import hparams as thp
    narrow = {"vqvae": dict(emb_width=16, l_bins=64, width=8, depth=1),
              "upsampler_level_0": dict(prior_width=32, prior_depth=1,
                                        cond_width=16, cond_depth=1),
              "upsampler_level_1": dict(prior_width=32, prior_depth=1,
                                        cond_width=16, cond_depth=1),
              "prior_1b_lyrics": dict(prior_width=32, prior_depth=2)}
    for name, over in narrow.items():
        monkeypatch.setitem(thp.HPARAMS_REGISTRY, name, thp.Hyperparams(
            thp.HPARAMS_REGISTRY[name], **over))
    chip_smoke.run_golden(0, "cpu")


# -- the training phases ------------------------------------------------------

# the 1b_lyrics training preset cut to a tiny top prior: 48 layers (f0 at
# 47), width 64, 64 codes + 384 lyric tokens; the f0 layer takes the flash
# path (plain versions on the CPU) once the length threshold is lowered
TRAIN_OVER = dict(n_ctx=64, sample_length=64 * 128, prior_depth=48,
                  prior_width=64, blocks=8, min_duration=0.5)


@pytest.fixture
def counted_flash(monkeypatch):
    """Count the plain flash passes run on the CPU, and put the tiny f0
    layer on the flash path."""
    from jukebox_tpu_torch.models import attention
    from jukebox_tpu_torch.ops import flash_attention as fa
    monkeypatch.setattr(attention, "_FLASH_MIN_CTX", 0)
    calls = dict.fromkeys(fa.LAUNCHES, 0)
    for name in calls:
        plain = getattr(fa, name + "_plain")

        def counted(*a, _name=name, _plain=plain, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(fa, name + "_plain", counted)
    return calls


def _count_plain(monkeypatch, mod, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        plain = getattr(mod, name + "_plain")

        def counted(*a, _name=name, _plain=plain, **kw):
            calls[_name] += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(mod, name + "_plain", counted)
    return calls


def test_cascade_layer_norm_accounting(priors, tmp_path, monkeypatch):
    from jukebox_tpu_torch.ops import layer_norm as ln
    calls = _count_plain(monkeypatch, ln, ln.LAUNCHES)
    hps = Hyperparams(n_samples=2, sample_length=VQ["sample_length"],
                      sr=VQ["sr"], hop_fraction=(1.0, 1.0, 0.125), seed=0,
                      name=str(tmp_path / "smoke"))
    # a 1-block prefill chunk: the 24-token lyric prefix takes one whole
    # chunk of 15 through the LayerNorm modules, its tail decode steps
    skw = [dict(temp=0.99, fp16=True, chunk_size=15, max_batch_size=2)
           for _ in priors]
    rep = chip_smoke.run_cascade(priors, hps, skw)
    # upsamplers: one conditioner LayerNorm per window (level 0: 128 codes
    # in 2 windows of 64, level 1: 64 in one); top: 2 per layer
    assert rep["ln_expected"] == {"layer_norm_fwd": 2 + 1 + 2 * 48,
                                  "layer_norm_bwd": 0}
    assert calls == rep["ln_expected"]
    assert rep["ln_launches"] == dict.fromkeys(ln.LAUNCHES, 0)


def test_layer_norm_checks():
    from jukebox_tpu_torch.ops import layer_norm as ln
    rows = chip_smoke.check_layer_norm(
        [(50, 33, torch.bfloat16), (20, 64, torch.float32)], "cpu",
        torch.Generator().manual_seed(0), time_it=False)
    assert set(rows) == set(ln.LAUNCHES)
    assert all(r["max_abs_err"] == 0.0 for r in rows.values())
    nbytes, flops = chip_smoke.layer_norm_work(6528, 2048, 2)[
        "layer_norm_fwd"]
    assert nbytes == 2 * 6528 * 2048 * 2 + 2 * 2048 * 4 + 2 * 6528 * 4


@pytest.mark.parametrize("offset", [False, True])
def test_bias_gelu_checks(offset):
    from jukebox_tpu_torch.ops import bias_gelu as bg
    rows = chip_smoke.check_bias_gelu(
        [(50, 33, torch.bfloat16), (20, 64, torch.float32)], "cpu",
        torch.Generator().manual_seed(0), time_it=False, offset=offset)
    assert set(rows) == set(bg.LAUNCHES)
    assert all(r["max_abs_err"] == 0.0 for r in rows.values())
    nbytes, flops = chip_smoke.bias_gelu_work(104448, 2048, 2)[
        "bias_gelu_bwd"]
    assert nbytes == 3 * 104448 * 2048 * 2 + 2 * 2048 * 4
    assert chip_smoke.bound(nbytes, flops, "fp32")[1] == "bytes"


@pytest.mark.parametrize("fp16", [False, True])
def test_adam_checks(fp16):
    gen = torch.Generator().manual_seed(0)
    start = {f"t{i}": torch.randn(s, generator=gen)
             for i, s in enumerate([(40, 30), (7,), (5000,)])}
    row = chip_smoke.check_adam(start, fp16, "cpu")
    assert row == {"max_abs_err": 0.0}  # CPU: the plain version twice
    nbytes, _ = chip_smoke.adam_work([10], fp16)
    assert nbytes == 10 * (20 if fp16 else 28)


def test_flash_checks():
    from jukebox_tpu_torch.ops import flash_attention as fa
    rows = chip_smoke.check_flash(1, 200, 64, 2, "cpu",
                                  torch.Generator().manual_seed(0),
                                  time_it=False, ragged=70)
    assert set(rows) == set(fa.LAUNCHES)
    assert all(r["max_abs_err"] == 0.0 for r in rows.values())
    bytes_, flops = chip_smoke.flash_work(2, 6528, 256)["flash_fwd"]
    assert flops == 2 * 2 * 256 * 2 * 6528 * 6529 // 2  # QK and PV


def test_train_step_check(counted_flash):
    from jukebox_tpu_torch.ops import bias_gelu as bg
    from jukebox_tpu_torch.ops import layer_norm as ln
    rep = chip_smoke.check_train_step(0, "cpu", torch.Generator(),
                                      **TRAIN_OVER)
    # CPU: no kernel
    assert rep["launches"] == dict.fromkeys(
        [*counted_flash, *ln.LAUNCHES, *bg.LAUNCHES], 0)
    # the kernel path, the plain path, the path with flash alone plain, the
    # planted fault and the step timed by parts (the profiled step runs on
    # the card only) each ran one step's passes; then phase 9 (c): the
    # c_res step twice and the c_attn / c_mlp step, whose f0 attention
    # forward runs a third time (its own recompute inside the block's)
    want = chip_smoke.expected_flash(1, 7)
    want["flash_fwd"] += 3
    want["flash_dq"] += 1
    want["flash_dkv"] += 1
    assert counted_flash == want
    c = rep["c_attn"]
    assert c["differ"] == [] and c["equal"] == c["n"] == c["repeat_equal"]
    assert c["loss"][0] == c["loss"][1] and c["gn"][0] == c["gn"][1]
    assert c["peak_gb"] == (None, None)  # not measured on the CPU
    # the decode check (op by op twice on the CPU): the tiny top's 64 codes
    assert rep["graph"]["same"] and rep["graph"]["n"] == 64


def test_training_run_launch_accounting(counted_flash):
    rep = chip_smoke.run_training(0, "cpu", n_steps=3, wav_seconds=1.0,
                                  **TRAIN_OVER)
    assert [r["it"] for r in rep["records"]] == [1, 2, 3]
    assert rep["n_flash_layers"] == 1
    assert rep["expected"] == {"flash_fwd": 6, "flash_dq": 3, "flash_dkv": 3}
    assert counted_flash == rep["expected"]
    assert rep["launches"] == dict.fromkeys(counted_flash, 0)
    assert rep["ema_updates"] == 1  # host EMA every 2 steps
    assert all(r["step_ok"] and r["loss_scale"] > 2 ** 16
               for r in rep["records"])


@pytest.mark.parametrize("name,group", [
    ("(anonymous namespace)::flash_dq_kernel(...)", "flash"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "matmul"),
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopA_TNT", "matmul"),
    ("void at::native::reduce_kernel<512, 1>", "reduce"),
    ("void at::native::direct_copy_kernel_cuda", "copy/cast"),
    ("void at::native::vectorized_elementwise_kernel<4, add>",
     "elementwise/other"),
])
def test_kernel_group(name, group):
    assert chip_smoke.kernel_group(name) == group


def test_checkpoint_phase(counted_flash, monkeypatch, tmp_path):
    from jukebox_tpu_torch.ops import adam as ad
    from jukebox_tpu_torch.ops import bias_gelu as bg
    from jukebox_tpu_torch.ops import layer_norm as ln
    ln_calls = _count_plain(monkeypatch, ln, ln.LAUNCHES)
    bg_calls = _count_plain(monkeypatch, bg, bg.LAUNCHES)
    adam_calls = _count_plain(monkeypatch, ad, ad.LAUNCHES)
    rep = chip_smoke.run_training(0, "cpu", n_steps=2, wav_seconds=1.0,
                                  logdir=str(tmp_path), **TRAIN_OVER)
    # two steps' LayerNorms and MLPs (twice in the forward under c_res) and
    # step 1's sample: two LayerNorms and one MLP per layer for each of its
    # 64 codes and of the 384-token lyric prefix's 6 whole chunks of
    # block_ctx 56 and 48 tail steps
    assert rep["kernel_expected"] == {
        "layer_norm_fwd": 2 * 2 * 96 + 96 * (64 + 6 + 48),
        "layer_norm_bwd": 2 * 96,
        "bias_gelu_fwd": 2 * 2 * 48 + 48 * (64 + 6 + 48),
        "bias_gelu_bwd": 2 * 48, "adam_update": 2}
    assert len(rep["samples"]) == 1
    assert dict(ln_calls, **bg_calls, **adam_calls) == rep["kernel_expected"]
    ckpt = rep["records"][0]["checkpoint"]
    assert ckpt == str(tmp_path / "smoke" / "checkpoint_latest.jkb")
    for calls in (counted_flash, ln_calls, bg_calls, adam_calls):
        for k in calls:
            calls[k] = 0
    res = chip_smoke.check_resume(0, "cpu", ckpt, n_more=2, wav_seconds=1.0,
                                  **TRAIN_OVER)
    assert res["step"] == 1 and [r["it"] for r in res["records"]] == [2, 3]
    assert dict(counted_flash, **ln_calls, **bg_calls,
                **adam_calls) == res["expected"]
    assert res["launches"] == dict.fromkeys(res["expected"], 0)
    assert res["bytes"] > 0
    # the sampling prior restored from the checkpoint holds it as
    # fp16_params casts it: bf16 weights, fp32 LayerNorms (g and b of the
    # two LayerNorms of every layer)
    tr_depth = TRAIN_OVER["prior_depth"]
    assert res["sampling_dtypes"]["torch.float32"] == 2 * 2 * tr_depth
    assert res["sampling_dtypes"]["torch.bfloat16"] > 0


# the tiny top with the lyric alignment's taps: its f7 layer 31, head 1
TAPS = dict(alignment_layer=31, alignment_head=1)


def test_context_and_alignment_accounting(tmp_path, monkeypatch):
    """Phases 4 and 4b at the sample CLI's hop fractions (0.5, 0.5, 0.125):
    windows that carry context prefill it in whole chunks and decode its
    tail, and the cascade's alignment forward (one hop over the padded top
    codes, the f0 layer on the flash path in bf16 once the length threshold
    is lowered, the recorded f7 layer dense) adds its flash_fwd and its two
    LayerNorms a layer. The plain calls of every decode, LayerNorm and
    flash kernel equal the expected counts, for the ancestral cascade and
    for the primed one (a 160-sample prompt of its first wav: 40, 20 and
    10 codes kept); check_alignment then calls get_alignment three times
    (kernel path, plain path, the planted head)."""
    from jukebox_tpu_torch import sample as sample_mod
    from jukebox_tpu_torch.models import attention
    from jukebox_tpu_torch.ops import flash_attention as fa
    from jukebox_tpu_torch.ops import layer_norm as ln
    monkeypatch.setattr(attention, "_FLASH_MIN_CTX", 0)
    vq = make_vqvae(setup_hparams("teeny", dict(VQ)), "cpu")
    priors = [make_prior(setup_hparams("teeny", dict(UP, level=0)), vq, "cpu"),
              make_prior(setup_hparams("teeny", dict(UP, level=1)), vq, "cpu"),
              make_prior(setup_hparams("teeny", dict(TOP, **TAPS)), vq, "cpu")]
    calls = [_count_plain(monkeypatch, m, m.LAUNCHES) for m in (ds, ln, fa)]
    seen = []
    monkeypatch.setattr(chip_smoke, "check_alignment",
                        lambda *a: seen.append(a) or {})

    def run(name, prompt=None):
        for c in calls:
            for k in c:
                c[k] = 0
        hps = Hyperparams(n_samples=2, sample_length=VQ["sample_length"],
                          sr=VQ["sr"], hop_fraction=(0.5, 0.5, 0.125),
                          seed=0, name=str(tmp_path / name))
        # a 2-block chunk of the upsamplers (bc 8), one block of the top's
        skw = [dict(temp=0.99, fp16=True, chunk_size=16, max_batch_size=2)
               for _ in priors]
        rep = chip_smoke.run_cascade(priors, hps, skw, prompt=prompt)
        assert calls[0] == rep["expected"]
        assert calls[1] == rep["ln_expected"]
        assert calls[2] == rep["fa_expected"]
        return rep, hps

    rep, hps = run("ancestral")
    # level 0: windows at 0, 32, 64 of 64 codes, the last two after 32
    # context tokens (2 chunks each); the top's 24-token lyric prefix is one
    # 15-token chunk and a 9-step tail
    assert chip_smoke.cascade_windows(priors, hps)[0] == [
        [(0, 64), (32, 32), (32, 32)], [(0, 64)], [(0, 32)]]
    assert rep["steps"] == [128, 64, 32 + 9]
    # conditioners 3 + 1 windows, 2 chunks x 3 layers x 2 in two windows,
    # the top's chunk x 48 layers x 2, the alignment's 48 x 2
    assert rep["ln_expected"]["layer_norm_fwd"] == 4 + 24 + 96 + 96
    assert rep["fa_expected"] == {"flash_fwd": 1, "flash_dq": 0,
                                  "flash_dkv": 0}
    assert rep["launches"] == dict.fromkeys(ds.LAUNCHES, 0)  # CPU
    wav = str(tmp_path / "ancestral" / "level_0" / "item_0.wav")
    x = sample_mod.load_prompts([wav], 160, hps)
    rep, hps = run("primed", x)
    assert rep["prompt"] == [40, 20, 10]
    assert chip_smoke.cascade_windows(priors, hps, rep["prompt"])[0] == [
        [(40, 24), (32, 32), (32, 32)], [(20, 44)], [(10, 32)]]
    # tails: 8 of level 0's first window, 4 of level 1's, the top's 34-token
    # prefill (lyrics and prompt) 2 chunks and a 4-step tail
    assert rep["steps"] == [24 + 8 + 32 + 32, 44 + 4, 32 + 4]
    assert rep["levels"][2]["tokens"] == 42  # the prompt + a window's 32
    assert rep["ln_expected"]["layer_norm_fwd"] == (
        3 + 2 * 3 * 6 + 1 + 2 * 3 + 2 * 48 * 2 + 96)
    assert [a[3][-1].shape[1] for a in seen] == [32, 42]
    monkeypatch.undo()
    monkeypatch.setattr(attention, "_FLASH_MIN_CTX", 0)
    calls = [_count_plain(monkeypatch, m, m.LAUNCHES) for m in (ln, fa)]
    out = chip_smoke.check_alignment(*seen[-1])
    assert calls[0]["layer_norm_fwd"] == 3 * 96 and calls[1]["flash_fwd"] == 3
    assert out["gap"] == 0.0 and out["fault_gap"] > chip_smoke.ALIGN_TOL
    assert out["launches"] == {"flash_fwd": 0, "layer_norm_fwd": 0}  # CPU
    assert out["expected"] == {"flash_fwd": 1, "layer_norm_fwd": 96}


# -- phase 8: the Quick start -------------------------------------------------

def _dataset_items(seconds, n_files, hps):
    """Items of the dataset over n_files songs of `seconds` each: (all,
    train, test)."""
    n = int(n_files * int(seconds * hps.sr) // hps.sample_length)
    train = int(n * hps.train_test_split)
    return n, train, n - train


def test_quick_start_plan():
    """Phase 8's sizes follow from the presets: each song holds the prior's
    2097152-sample window, the prior's dataset a training batch of 4 and a
    test item (an epoch is one step), the VQ-VAE's six steps fit in one
    epoch; the prior's expected launches: no flash (attn_order 2 has no
    dense layer), its 96 LayerNorms twice in the forward under c_res, once
    in the backward and once per test batch, one Adam update a step."""
    vq = chip_smoke.quick_start_hps("vqvae", 0)
    pr = chip_smoke.quick_start_hps("prior", 0)
    assert (vq.sr, vq.sample_length, vq.bs, vq.levels) == (22050, 262144, 4,
                                                           2)
    assert (pr.sample_length, pr.n_ctx, pr.prior_depth, pr.prior_width,
            pr.c_res, pr.attn_order) == (2097152, 8192, 48, 1024, 1, 2)
    assert pr.sample_length // (2 ** 5 * 2 ** 3) == pr.n_ctx
    seconds = chip_smoke.song_seconds(pr)
    assert seconds == 239 and seconds * pr.sr >= pr.sample_length
    assert _dataset_items(seconds, 2, pr) == (5, 4, 1)
    n, train, test = _dataset_items(seconds, 2, vq)
    assert (n, train) == (40, 36) and train // vq.bs >= chip_smoke.VQ_STEPS
    assert chip_smoke.expected_quick_start(pr, 3, 3) == {
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
        "layer_norm_fwd": 2 * 96 * 3 + 96 * 3, "layer_norm_bwd": 96 * 3,
        "bias_gelu_fwd": 2 * 48 * 3 + 48 * 3, "bias_gelu_bwd": 48 * 3,
        "adam_update": 3}
    big = setup_hparams("vqvae", dict(chip_smoke.BIG_VQ_KW))
    assert (big.levels, tuple(big.downs_t), tuple(big.hvqvae_multipliers),
            big.l_bins, big.loss_fn, big.restore_vqvae) == (
        3, (3, 2, 2), (2, 1, 1), 2048, "lmix", "")
    # the bottom level's rows against its codes: a 1 GiB distance matrix
    # whole, cut into row chunks of at most 2**26 elements
    rows = big.sample_length // 8 * big.bs
    assert rows == 131072
    from jukebox_tpu_torch.models import bottleneck as bn
    chunks = bn._chunks(rows, big.l_bins)
    assert len(chunks) == 4 and chunks[-1][1] == rows


# phase 8 cut to toy size: the same presets, narrower, shorter and at
# 8 kHz from songs at 16 kHz; the prior 3 layers over 16 codes
QS_VQ = dict(sample_length=2048, sr=8000, width=8, depth=1, emb_width=16,
             l_bins=32, bs=2)
QS_PRIOR = dict(QS_VQ, sample_length=16 * 256, n_ctx=16, prior_width=32,
                prior_depth=3, blocks=4)


def test_quick_start_rehearsal(tmp_path, monkeypatch):
    """Phase 8's functions on the CPU at toy size: the plain calls of the
    Adam, LayerNorm, bias_gelu and flash kernels equal the expected
    launches of (a), (b)'s step and (c)'s run (before its kernel checks);
    the checkpoint restores bit for bit and with the fine-tuning reset;
    (b)'s Adam check and (c)'s LayerNorm (at the run's rows) and Adam (on
    the prior's tensors) checks hold the plain versions to themselves; (c)
    writes checkpoint_latest.jkb at step 1."""
    from jukebox_tpu_torch.ops import adam as ad
    from jukebox_tpu_torch.ops import bias_gelu as bg
    from jukebox_tpu_torch.ops import flash_attention as fa
    from jukebox_tpu_torch.ops import layer_norm as ln
    counters = [_count_plain(monkeypatch, m, m.LAUNCHES)
                for m in (ad, ln, bg, fa)]

    def counts():
        return {k: v for c in counters for k, v in c.items()}

    def reset():
        for c in counters:
            for k in c:
                c[k] = 0
    songs = tmp_path / "songs"
    songs.mkdir()
    seconds = chip_smoke.song_seconds(chip_smoke.quick_start_hps(
        "prior", 0, **QS_PRIOR))
    assert seconds == 2
    paths = chip_smoke.write_songs(str(songs), seconds, 16000, 0)
    from jukebox_tpu_torch.utils import wavio
    assert [wavio.probe(p)["format"] for p in paths] == [3, 1]
    a = chip_smoke.run_vq_quick_start(0, "cpu", str(songs),
                                      str(tmp_path / "logs"), **QS_VQ)
    assert [r["it"] for r in a["records"]] == list(range(1, 7))
    assert counts() == a["expected"] and a["expected"]["adam_update"] == 6
    assert a["launches"] == dict.fromkeys(counts(), 0)  # CPU: no kernel
    assert a["checkpoint"].endswith("small_vqvae/checkpoint_step_1.jkb")
    assert chip_smoke.check_vq_restore(0, "cpu", a["checkpoint"],
                                       **QS_VQ) == 1
    reset()
    b = chip_smoke.check_vqvae_step(
        0, "cpu", str(songs), torch.Generator().manual_seed(0),
        **dict(QS_VQ, l_bins=64))
    assert b["adam"] == {"max_abs_err": 0.0}
    # the Adam check's two runs of 3 updates (the plain version, then the
    # wrapper, which runs it on the CPU), and the step's one update
    assert counts()["adam_update"] == 2 * 3 + 1 and np.isfinite(b["loss"])
    reset()
    before_checks, ln_shapes = {}, []
    check_layer_norm = chip_smoke.check_layer_norm

    def counted_check(shapes, *args, **kw):
        before_checks.update(counts())
        ln_shapes.extend(shapes)
        return check_layer_norm(shapes, *args, **kw)
    monkeypatch.setattr(chip_smoke, "check_layer_norm", counted_check)
    c = chip_smoke.run_prior_quick_start(
        0, "cpu", str(songs), a["checkpoint"], str(tmp_path / "logs"),
        torch.Generator().manual_seed(0), **QS_PRIOR)
    assert [r["it"] for r in c["records"]] == [1, 2, 3]
    assert c["n_flash_layers"] == 0 and c["n_depth"] == 3
    # one epoch of 3 steps, one test batch, and step 1's sample: two
    # LayerNorms per layer for each of its 16 codes
    want = chip_smoke.expected_quick_start(
        chip_smoke.quick_start_hps("prior", 0, **QS_PRIOR), 3, 1)
    want["layer_norm_fwd"] += 2 * 3 * 16
    want["bias_gelu_fwd"] += 3 * 16
    assert c["expected"] == want
    assert before_checks == c["expected"]
    assert c["checkpoint"].endswith("small_prior/checkpoint_latest.jkb")
    assert ln_shapes == [(2 * 16, 32, torch.bfloat16)]
    assert c["rows"] == dict.fromkeys(
        ("layer_norm_fwd", "layer_norm_bwd", "adam_update"),
        {"max_abs_err": 0.0})
    assert len(list(songs.glob("*.wav.dur"))) == 2  # durations cached


# -- phase 9: the recipes ----------------------------------------------------

def test_recipes_plan(monkeypatch):
    """Phase 9's configurations follow the README's recipes: the upsampler
    at its published widths and depth over the small_vqvae; the labelled
    and lyric priors over the 3-level vqvae at sample_length n_ctx x 128,
    under their min_duration, with labels inside y_bins (and a label
    outside refused); the cut depths keep the sep-enc-dec prior's first f6
    layer; phase 2b's head-dim-128 shape is the single-enc-dec prior's f0
    layer; phase 8's songs hold a batch and a test item of every recipe."""
    from jukebox_tpu_torch.models.transformer import ATTN_ORDERS
    up = chip_smoke.recipe_hps("small_upsampler", 0)
    assert (up.n_ctx, up.prior_width, up.prior_depth, up.cond_depth,
            up.cond_width, up.levels, up.level, up.labels, up.bs) == (
        8192, 1024, 48, 16, 512, 2, 0, False, 4)
    assert up.sample_length == up.n_ctx * 2 ** 5
    assert (up.save_iters, up.debug_speed, up.test) == (2, True, True)
    seconds = chip_smoke.song_seconds(chip_smoke.quick_start_hps("prior", 0))
    for preset, length in chip_smoke.LABELLED_LENGTH.items():
        h = chip_smoke.recipe_hps(preset, 0)
        assert h.sample_length == length == h.n_ctx * 128
        assert length < h.min_duration * h.sr and seconds >= h.min_duration
        assert (h.levels, h.level, h.labels, h.restore_vqvae) == (3, 2, True,
                                                                  "")
        assert chip_smoke.recipe_label_ids(h) == (3, [9])
        assert _dataset_items(seconds, 2, h)[1:] >= (h.bs, 1)
        funcs = [ATTN_ORDERS[h.attn_order](d) for d in
                 range(chip_smoke.CUT_DEPTH[preset])]
        if preset == "small_sep_enc_dec_prior":
            assert funcs.index(6) == chip_smoke.CUT_DEPTH[preset] - 1 == 9
        else:
            assert 6 not in funcs and chip_smoke.CUT_DEPTH[preset] == 4
    assert _dataset_items(seconds, 2, up)[1:] >= (up.bs, 1)
    h = chip_smoke.recipe_hps("small_single_enc_dec_prior", 0)
    f = chip_smoke.FLASH128
    assert (f["L"], f["S"] // f["H"], f["B"], f["H"]) == (
        h.n_ctx + h.n_tokens, 128, h.bs, h.heads)
    assert f["S"] == int(h.prior_width * h.m_attn)
    assert [d for d in range(h.prior_depth)
            if ATTN_ORDERS[h.attn_order](d) == 0] == [47]
    monkeypatch.setattr(chip_smoke, "RECIPE_ARTIST", "the beatles")
    with pytest.raises(AssertionError, match="outside y_bins"):
        chip_smoke.recipe_label_ids(h)


# phase 9 cut to toy size over phase 8 (a)'s toy VQ-VAE (QS_VQ): each
# recipe's presets, narrower, shorter and at 8 kHz, min_duration under the
# toy songs' 2 s
TOY_UPS = dict(QS_VQ, sample_length=2048, n_ctx=64, prior_width=32,
               prior_depth=2, blocks=4, cond_width=16, cond_depth=2)
TOY_LAB = dict(width=8, depth=1, emb_width=16, l_bins=32, sr=8000, bs=2,
               sample_length=2048, n_ctx=16, prior_width=32, min_duration=0.5)
TOY = {"small_labelled_prior": dict(TOY_LAB, prior_depth=3, blocks=4),
       "small_single_enc_dec_prior": dict(TOY_LAB, prior_depth=4, blocks=8),
       "small_sep_enc_dec_prior": dict(TOY_LAB, prior_depth=10, blocks=4,
                                       prime_width=32, prime_depth=2,
                                       prime_blocks=32)}


def test_recipes_rehearsal(tmp_path, monkeypatch):
    """Phase 9's functions on the CPU at toy size: each recipe's train.run
    with its in-training sample, its logs (read back by check_logs:
    events through utils/logger.py read_events, wavs, JSONL) and, for the
    upsampler, its debug_speed trace; the plain calls of the LayerNorm,
    bias_gelu, flash and Adam kernels equal each run's expected launches,
    its sample's as sample_layer_norms and sample_bias_gelu count them; a
    full-depth single-enc-dec step against its plain path and flash alone
    plain."""
    from jukebox_tpu_torch.models import attention
    from jukebox_tpu_torch.ops import adam as ad
    from jukebox_tpu_torch.ops import bias_gelu as bg
    from jukebox_tpu_torch.ops import flash_attention as fa
    from jukebox_tpu_torch.ops import layer_norm as ln
    monkeypatch.setattr(attention, "_FLASH_MIN_CTX", 0)
    counters = [_count_plain(monkeypatch, m, m.LAUNCHES)
                for m in (ad, ln, bg, fa)]

    def counts():
        return {k: v for c in counters for k, v in c.items()}

    def reset():
        for c in counters:
            for k in c:
                c[k] = 0
    songs = tmp_path / "songs"
    songs.mkdir()
    chip_smoke.write_songs(str(songs), 2, 16000, 0)
    logdir = str(tmp_path / "logs")
    a = chip_smoke.run_vq_quick_start(0, "cpu", str(songs), logdir, **QS_VQ)
    reset()
    up = chip_smoke.run_recipe("small_upsampler", 0, "cpu", str(songs),
                               logdir, 3, graph_check=16,
                               restore_vqvae=a["checkpoint"], **TOY_UPS)
    assert up["graph"]["same"] and up["graph"]["n"] == 16
    assert [r["it"] for r in up["records"]] == [1, 2, 3]
    # and the decode check's two runs: the conditioner's LayerNorm and two
    # a layer for each of 16 tokens, and one MLP a layer for each
    assert counts() == dict(up["expected"], layer_norm_fwd=up["expected"][
        "layer_norm_fwd"] + 2 * (1 + 2 * 2 * 16), bias_gelu_fwd=up[
        "expected"]["bias_gelu_fwd"] + 2 * 2 * 16)
    # 3 steps (the conditioner's LayerNorm and the transformer's two a
    # layer, twice in the forward under c_res), one test batch, and the
    # sample: two a layer for each of its 64 codes and the conditioner's
    assert up["expected"]["layer_norm_fwd"] == 3 * (2 * 4 + 1) + (4 + 1) \
        + (4 * 64 + 1)
    assert up["samples"][0]["shape"] == (2, 64)
    assert up["logs"]["audio"] == 2 + 2 * 2  # the sample, steps 1 and 3
    assert up["logs"]["jsonl"] == 3 and up["trace"][0] > 0
    chip_smoke.log_recipe("(a)", up)
    for preset, over in TOY.items():
        reset()
        r = chip_smoke.run_recipe(preset, 0, "cpu", str(songs), logdir, 2,
                                  **over)
        assert counts() == r["expected"], preset
        assert r["samples"][0]["shape"] == (2, 16)
        assert r["logs"]["audio"] == 2 + 2
        chip_smoke.log_recipe(f"(b) {preset}", r)
    reset()
    step = chip_smoke.check_recipe_step(
        "small_single_enc_dec_prior", 0, "cpu",
        torch.Generator().manual_seed(0),
        **dict(TOY["small_single_enc_dec_prior"], prior_depth=48))
    assert step["n_flash_layers"] == 1 and "flash" in step
    assert all(v == 0.0 for v in step["full"].values())
    # the planted LayerNorm faults move the step; the vector one beyond
    # RECIPE_TOL (check_recipe_step raises otherwise)
    assert all(v > 0.0 for f in step["faults"].values() for v in f.values())
    # the kernel path, the plain path, the two planted LayerNorm faults
    # and flash alone plain
    assert counts()["flash_dq"] == 5


# phase 10 at a tiny depth and width: 4 layers of the 1b top's order at
# width 64 (2 heads: the Megatron split takes one a rank)
P10_OVER = dict(n_ctx=64, sample_length=64 * 128, prior_depth=4,
                prior_width=64, blocks=8, min_duration=0.5)
# and its upsampler: 2 layers at width 64 (one head, whole on each rank), a
# 2-layer conditioner at 32
P10_UP_OVER = dict(n_ctx=64, sample_length=64 * 32, prior_depth=2,
                   prior_width=64, blocks=8, cond_width=32, cond_depth=2,
                   min_duration=0.1)


def test_phase10_rehearsal():
    """Phase 10 on the CPU: world 1's references, (a) in this process over
    gloo, (b) two chip_smoke.py ranks over gloo; every part runs (gloo
    carries every collective on CPU tensors) and holds."""
    rep = chip_smoke.run_phase10(0, "cpu", up_over=P10_UP_OVER, **P10_OVER)
    gaps = rep["a"]["gaps"]
    assert gaps["loss"] == gaps["gn"] == gaps["params"] == 0.0
    assert gaps["equal tensors"][0] == gaps["equal tensors"][1]
    b = rep["b"]
    assert set(b) == set(chip_smoke.P10_PARTS)
    for part in ("dp", "fsdp", "dp_drop"):
        assert b[part]["loss"][0] == b[part]["loss"][1]
    assert all(n < b["fsdp"]["ref_bytes"] * 0.6
               for n in b["fsdp"]["state_bytes"])
    assert all(n < b["mp"]["ref_bytes"] for n in b["mp"]["state_bytes"])
    assert b["decode"]["rel"] <= chip_smoke.STEP_TOL
    assert b["decode_int8"]["rel"] <= chip_smoke.STEP_TOL
    assert b["up_decode"]["rel"] <= chip_smoke.STEP_TOL
    assert rep["launches"] == dict.fromkeys(rep["launches"], 0)  # CPU


def test_phase10_refuses_a_faulty_gather(monkeypatch):
    """(a) must refuse a ZeRO-3 gather that halves what it gathers (at
    this width the blocks' parameters are whole: the embeddings outside
    them are sharded)."""
    from torch.distributed.fsdp._fully_shard._fsdp_param_group import \
        FSDPParamGroup
    real = FSDPParamGroup.wait_for_unshard

    def faulty(self):
        fresh = bool(self._all_gather_result)
        real(self)
        if fresh:
            for fp in self.fsdp_params:
                for t in fp.all_gather_outputs:
                    # as FSDP's own copy: autograd keeps what it saved
                    with torch.no_grad(), \
                            torch.autograd._unsafe_preserve_version_counter(t):
                        t.mul_(0.5)
    monkeypatch.setattr(FSDPParamGroup, "wait_for_unshard", faulty)
    monkeypatch.setattr(chip_smoke, "p10_launch", None)  # (b) not reached
    with pytest.raises(AssertionError, match="phase 10 \\(a\\)"):
        chip_smoke.run_phase10(0, "cpu", up_over=P10_UP_OVER, **P10_OVER)


def test_summary_kernel_check():
    """Phase 2's f4 check at a toy width: the kernel's plain version agrees
    with itself, and the planted fault (the summary one row off) is
    refused at every block end."""
    rows = {}
    row = chip_smoke.check_summary_attn(
        rows, 2, "cpu", torch.Generator().manual_seed(0), time_it=False,
        sh=dict(A=16, H=2, blocks=8, bc=6))
    assert row["max_abs_err"] == 0.0 and rows["ring_attn_decode"]["f4"] is row
    assert chip_smoke.summary_positions(chip_smoke.SUMMARY)[-1] == 6143


# phase 11 at a toy width: orders 3 and 5 at the depths whose plans the
# card's share (order 3: one scan, nothing packed; order 5 at 9: f1 packed,
# f4 not), n_ctx 96 in 8 blocks of 12
P11_OVER = dict(n_ctx=96, sample_length=96 * 128, prior_width=32, blocks=8)


def test_phase11_rehearsal(monkeypatch):
    """Phase 11 on the CPU: both priors, bf16 and int8, through the
    PriorRuntime pieces; the decode kernels' plain calls equal the expected
    launches plus the two kernel-against-plain checks (each a step through
    the kernel path and one through the plain path), the LayerNorm calls
    the prefill's."""
    from jukebox_tpu_torch.ops import layer_norm as ln
    calls = _count_plain(monkeypatch, ds, ds.LAUNCHES)
    ln_calls = _count_plain(monkeypatch, ln, ln.LAUNCHES)
    rep = chip_smoke.run_phase11(0, "cpu", B=2, **P11_OVER)
    want = dict.fromkeys(ds.LAUNCHES, 0)
    ln_want = dict.fromkeys(ln.LAUNCHES, 0)
    for what in ("order 3 bf16", "order 3 int8", "order 5 bf16",
                 "order 5 int8"):
        r = rep[what]
        assert r["tokens"] == 4 * 12 and r["checks"] == 2
        per = {k: v // r["tokens"] for k, v in r["expected"].items()}
        for k in want:
            want[k] += r["expected"][k] + 2 * r["checks"] * per[k]
        for k in ln_want:
            ln_want[k] += r["ln_expected"][k]
        assert all(rel <= chip_smoke.STEP_TOL for rel in r["rel"])
    assert rep["order 3 int8"]["int8_layers"] == []
    assert rep["order 5 int8"]["int8_layers"] == [0, 2, 3, 4, 6, 7, 8]
    assert rep["order 5 int8"]["expected"]["ring_attn_int8"] == 48 * 7
    assert rep["order 5 int8"]["expected"]["ring_attn_decode"] == 48 * 2
    assert rep["order 3 bf16"]["expected"]["ring_attn_decode"] == 48 * 8
    assert calls == want
    assert ln_calls == ln_want
    assert rep["launches"] == dict.fromkeys(ds.LAUNCHES, 0)  # CPU
