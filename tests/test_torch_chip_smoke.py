"""Rehearsal of chip_smoke.py on the CPU at toy size: its kernel checks, the
decode-step check and the cascade with its launch accounting run through
the same functions as on the card, with the wrappers' plain versions (CPU
tensors). The expected per-kernel launch counts that the card run holds
the kernels' counters to must equal the number of plain-version calls the
cascade makes here, for the decode kernels and the LayerNorm kernels; the
same holds for the training phases (flash, LayerNorm, Adam), including the
save at step 1 and the run restored from that checkpoint."""

import sys
from pathlib import Path

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
    launches = chip_smoke.check_train_step(0, "cpu", torch.Generator(),
                                           **TRAIN_OVER)
    assert launches == dict.fromkeys(counted_flash, 0)  # CPU: no kernel
    # the kernel path, the plain path, the path with flash alone plain, the
    # planted fault and the step timed by parts (the profiled step runs on
    # the card only) each ran one step's passes
    assert counted_flash == chip_smoke.expected_flash(1, 5)


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
    from jukebox_tpu_torch.ops import layer_norm as ln
    ln_calls = _count_plain(monkeypatch, ln, ln.LAUNCHES)
    adam_calls = _count_plain(monkeypatch, ad, ad.LAUNCHES)
    rep = chip_smoke.run_training(0, "cpu", n_steps=2, wav_seconds=1.0,
                                  logdir=str(tmp_path), **TRAIN_OVER)
    assert rep["kernel_expected"] == {"layer_norm_fwd": 2 * 2 * 96,
                                      "layer_norm_bwd": 2 * 96,
                                      "adam_update": 2}
    assert dict(ln_calls, **adam_calls) == rep["kernel_expected"]
    ckpt = rep["records"][0]["checkpoint"]
    assert ckpt == str(tmp_path / "smoke" / "checkpoint_latest.jkb")
    for calls in (counted_flash, ln_calls, adam_calls):
        for k in calls:
            calls[k] = 0
    res = chip_smoke.check_resume(0, "cpu", ckpt, n_more=2, wav_seconds=1.0,
                                  **TRAIN_OVER)
    assert res["step"] == 1 and [r["it"] for r in res["records"]] == [2, 3]
    assert dict(counted_flash, **ln_calls, **adam_calls) == res["expected"]
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
