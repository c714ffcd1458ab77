"""The MLP's bias + quick_gelu (jukebox_tpu_torch/ops/bias_gelu.py): its
plain versions, its autograd function in the MLP and the transformer block,
and, on the card, its kernels (csrc/bias_gelu.cu).

CPU: the plain forward and backward against autograd of quick_gelu(y + b)
in fp64, within the one rounding to the output dtype (half a step of it)
plus the fp32 arithmetic's error (1e-6 of |do|, |dpre| and |o|; db, a sum
of up to 64 rows in fp32, 1e-5 of the sum of its terms' sizes); the MLP and
the block against the eager expression they replace in fp32, outputs and
every gradient within 1e-5 of the tensor's scale (the same function,
rounded in fp32 at other places); the plain flag reaching the block's MLP;
the launch counts of a training forward and backward under checkpoint_res
as LAUNCHES_PER_STEP says, counted on the plain versions.

GPU (skips itself without a card): the kernels against their plain
versions through chip_smoke.check_bias_gelu at the main path's widths
(2048, 1920, 4800, 1024) and an odd one, in fp32, bf16 and fp16, and at a
storage offset (the element path), held to ops/layer_norm.py `agreement`
(two steps of the output dtype of |plain| plus 1e-4 of the tensor's RMS:
both round the same fp32 expression once, the card's expf and division
may differ from PyTorch's in the last fp32 bits, and db sums the rows in
another order), with a planted fault (the last row skipped) refused; a
launch inside a CUDA graph capture replays to the eager launch's bits; one
training step of a small prior counts LAUNCHES_PER_STEP x its layers.
This file imports no JAX:
    python -m pytest --noconftest tests/test_torch_bias_gelu.py -q
"""

import sys
from pathlib import Path

import pytest
import torch

from jukebox_tpu_torch.models import transformer as tfm
from jukebox_tpu_torch.models.transformer import MLP, ResAttnBlock, Transformer
from jukebox_tpu_torch.ops import bias_gelu as bg
from jukebox_tpu_torch.ops.core import quick_gelu

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _init(mod, seed):
    """Every parameter of mod drawn from the seed, biases included (the
    init leaves them 0, which would hide where the bias is added)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    mod.requires_grad_()


def _fp64_ref(y, b, do):
    yd = y.double().requires_grad_()
    bd = b.double().requires_grad_()
    o = quick_gelu(yd + bd)
    o.backward(do.double())
    return o.detach(), yd.grad, bd.grad


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(64, 48), (5, 33)], ids=str)
def test_plain_versions_match_fp64_autograd(dtype, shape):
    gen = torch.Generator().manual_seed(1)
    y = (2.0 * torch.randn(shape, generator=gen) - 0.3).to(dtype)
    b = 0.5 * torch.randn(shape[-1], generator=gen)
    do = torch.randn(shape, generator=gen).to(dtype)
    ref_o, ref_dy, ref_db = _fp64_ref(y, b, do)
    half = torch.finfo(dtype).eps / 2
    tiny = torch.finfo(dtype).tiny * torch.finfo(dtype).eps
    o = bg.bias_gelu_fwd_plain(y, b)
    dpre, db = bg.bias_gelu_bwd_plain(y, b, do)
    assert o.dtype == dpre.dtype == dtype and db.dtype == torch.float32
    assert ((o.double() - ref_o).abs()
            <= half * ref_o.abs() + 1e-6 * ref_o.abs() + tiny).all()
    assert ((dpre.double() - ref_dy).abs()
            <= (half + 1e-6) * ref_dy.abs() + 1e-6 * do.double().abs()
            + tiny).all()
    # db sums the fp32 dpre before its rounding
    terms = (ref_dy.abs()).sum(0)
    assert ((db.double() - ref_db).abs() <= 1e-5 * terms + 1e-12).all()


def test_wrappers_take_the_plain_versions_on_the_cpu():
    gen = torch.Generator().manual_seed(2)
    y, do = torch.randn((20, 16), generator=gen), torch.randn((20, 16),
                                                               generator=gen)
    b = torch.randn(16, generator=gen)
    assert torch.equal(bg.bias_gelu_fwd(y, b), bg.bias_gelu_fwd_plain(y, b))
    assert all(torch.equal(a, r) for a, r in zip(
        bg.bias_gelu_bwd(y, b, do), bg.bias_gelu_bwd_plain(y, b, do)))
    assert bg.LAUNCHES == dict.fromkeys(bg.LAUNCHES, 0)  # CPU: no kernel


def _grads(fn, mod, x):
    mod.zero_grad()
    x = x.detach().clone().requires_grad_()
    out = fn(x)
    out.backward(torch.ones_like(out) * 0.7)
    return [out.detach(), x.grad] + [p.grad.clone() for p in
                                     mod.parameters()]


def _close(got, want):
    for g, w in zip(got, want):
        scale = max(w.abs().max().item(), 1.0)
        assert (g - w).abs().max().item() <= 1e-5 * scale


def _eager(monkeypatch):
    """transformer.bias_quick_gelu replaced by the eager expression it
    stands for (dense's bias add in y's dtype, then quick_gelu)."""
    monkeypatch.setattr(tfm, "bias_quick_gelu",
                        lambda y, b, plain=False:
                        quick_gelu(y + b.to(y.dtype)))


def test_mlp_gradients_match_the_eager_expression(monkeypatch):
    mlp = MLP(16, 40, device="cpu")
    _init(mlp, 3)
    x = torch.randn(2, 7, 16, generator=torch.Generator().manual_seed(4))
    got = _grads(mlp, mlp, x)
    _eager(monkeypatch)
    _close(got, _grads(mlp, mlp, x))


@pytest.mark.parametrize("checkpoint_mlp", [0, 1])
def test_block_gradients_match_the_eager_expression(monkeypatch,
                                                    checkpoint_mlp):
    blk = ResAttnBlock(16, 8, 2, 1, blocks=2, checkpoint_mlp=checkpoint_mlp,
                       device="cpu")
    _init(blk, 5)
    x = torch.randn(1, 8, 16, generator=torch.Generator().manual_seed(6))

    def run(h):
        return blk(h)[0]
    got = _grads(run, blk, x)
    _eager(monkeypatch)
    _close(got, _grads(run, blk, x))


def _count(monkeypatch):
    calls = dict.fromkeys(bg.LAUNCHES, 0)
    for name in bg.LAUNCHES:
        plain = getattr(bg, name + "_plain")

        def counted(*a, _name=name, _plain=plain):
            calls[_name] += 1
            return _plain(*a)
        monkeypatch.setattr(bg, name + "_plain", counted)
    return calls


def test_block_threads_plain_to_its_mlp(monkeypatch):
    seen = []
    real = bg.BiasGeluFn.apply
    monkeypatch.setattr(bg.BiasGeluFn, "apply",
                        lambda y, b, plain: seen.append(plain)
                        or real(y, b, plain))
    blk = ResAttnBlock(16, 8, 2, 1, blocks=2, device="cpu")
    _init(blk, 7)
    x = torch.randn(1, 8, 16)
    blk(x, plain=True)
    blk(x)
    assert seen == [True, False]


def test_checkpointed_forward_and_backward_count_launches_per_step(
        monkeypatch):
    """A transformer under checkpoint_res=1 runs each MLP's forward twice
    (the backward's recompute) and its backward once: LAUNCHES_PER_STEP
    per layer, counted on the plain versions the CPU runs."""
    calls = _count(monkeypatch)
    tr = Transformer(16, 8, 2, 3, attn_order=2, blocks=2, checkpoint_res=1,
                     device="cpu")
    _init(tr, 8)
    x = torch.randn(2, 8, 16, requires_grad=True)
    out, _ = tr(x, fp16=True)
    out.float().sum().backward()
    assert calls == {k: v * 3 for k, v in bg.LAUNCHES_PER_STEP.items()}
    with torch.no_grad():
        tr(x, fp16=True)
    assert calls["bias_gelu_fwd"] == 2 * 3 + 3


# -- on the card --------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernels_match_plain(dtype):
    _cuda()
    rows = chip_smoke.check_bias_gelu(
        [(8192, 2048, dtype), (4096, 1920, dtype), (2048, 4800, dtype),
         (2048, 1024, dtype), (300, 1001, dtype), (3, 7, dtype)],
        "cuda", torch.Generator(device="cuda").manual_seed(9), time_it=False)
    assert set(rows) == set(bg.LAUNCHES)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kernels_at_a_storage_offset(dtype):
    _cuda()
    chip_smoke.check_bias_gelu(
        [(300, 2048, dtype), (40, 4800, dtype), (17, 1001, dtype)], "cuda",
        torch.Generator(device="cuda").manual_seed(10), time_it=False,
        offset=True)


@pytest.mark.gpu
def test_a_captured_launch_replays_to_the_same_output():
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    y = torch.randn((16, 2048), generator=gen, device="cuda").bfloat16()
    b = torch.randn(2048, generator=gen, device="cuda")
    bg.bias_gelu_fwd(y, b)  # built and loaded outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = dict(bg.LAUNCHES)
    with torch.cuda.graph(graph):
        out = bg.bias_gelu_fwd(y, b)
    assert bg.LAUNCHES["bias_gelu_fwd"] == before["bias_gelu_fwd"] + 1
    for _ in range(2):
        y.copy_(torch.randn((16, 2048), generator=gen,
                            device="cuda").bfloat16())
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, bg.bias_gelu_fwd(y, b))
    assert bg.LAUNCHES["bias_gelu_fwd"] == before["bias_gelu_fwd"] + 3


@pytest.mark.gpu
def test_a_prior_train_step_counts_launches_per_step():
    """One training forward and backward of a small prior (3 layers at
    width 256, checkpoint_res=1) launches LAUNCHES_PER_STEP x 3."""
    _cuda()
    from jukebox_tpu_torch import hparams as thp
    from jukebox_tpu_torch.models.make_models import make_prior, make_vqvae
    hps = thp.setup_hparams("teeny", dict(
        sample_length=256, levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2),
        emb_width=16, l_bins=32, width=8, depth=1, m_conv=1.0,
        dilation_growth_rate=1, sr=8000, level=2, n_ctx=24,
        prior_width=256, prior_depth=3, heads=2, blocks=4, attn_order=2,
        init_scale=0.7, min_duration=0.0, max_duration=600.0, labels=False,
        train=True, c_res=1))
    rt = make_prior(hps, make_vqvae(hps, "cuda"), "cuda")
    m = rt.model
    assert m.prior.transformer.checkpoint_res == 1
    z = torch.randint(0, 32, (4, 24), device="cuda")
    before = dict(bg.LAUNCHES)
    loss, _ = m.z_forward(z, fp16=True)
    loss.backward()
    torch.cuda.synchronize()
    assert {k: bg.LAUNCHES[k] - before[k] for k in bg.LAUNCHES} == {
        k: v * 3 for k, v in bg.LAUNCHES_PER_STEP.items()}
