"""The prior options the port builds since it stopped refusing them,
against jukebox_tpu on the CPU on converted params, fp32: the summary
attention patterns 4 and 5 (attn orders 3, 4 and 5, `spread` feeding
pattern 5), the lyric encoder's prime_spread (a separate encoder-decoder
prior whose lyric encoder runs attn order 4), and copy_input (the lyric
stream taken from the window's first codes). Each: the loss (within 1e-5)
and the teacher-forced logits (rtol / atol 1e-4, tests/test_torch_prior.py's
tolerance) of z_forward against the JAX z_forward on the same codes and
labels. pos_init and prime_pos_init stay refused, as the JAX package
asserts them off; the summary-spread pattern (5) does not decode in either
package (the summary pattern 4 does: tests/test_torch_summary_decode.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu import hparams as jhp
from jukebox_tpu.models import make_models as jmm
from jukebox_tpu_torch import hparams as thp
from jukebox_tpu_torch.models import make_models as tmm
from jukebox_tpu_torch.utils.convert import from_jax_params

from test_torch_prior import META, TOP, VQ

torch.set_num_threads(1)
N = 2
SEP = dict(TOP, single_enc_dec=False, attn_order=6, prior_depth=4,
           prime_width=16, prime_depth=2, prime_heads=2, prime_blocks=4,
           prime_attn_order=4, prime_spread=2, prime_init_scale=0.7)
CASES = {
    "order3_summary": dict(TOP, attn_order=3, prior_depth=4),
    "order4_spread": dict(TOP, attn_order=4, prior_depth=4, spread=2),
    "order5_summary": dict(TOP, attn_order=5, prior_depth=4),
    "prime_spread": SEP,
    "copy_input": dict(TOP, prior_depth=4, attn_order=2, copy_input=True),
}


def _build(cfg):
    jvq = jmm.make_vqvae(jhp.setup_hparams("teeny", dict(VQ)))
    jp = jmm.make_prior(jhp.setup_hparams("teeny", dict(cfg)), jvq)
    tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    tp = tmm.make_prior(thp.setup_hparams("teeny", dict(cfg)), tvq, "cpu")
    from_jax_params(tp.model, jax.tree_util.tree_map(np.asarray, jp.params))
    y = jp.get_y(jp.labeller.get_batch_labels([META] * N), 0)
    z = np.random.RandomState(1).randint(0, VQ["l_bins"], (N, jp.n_ctx))
    return jp, tp, y, z


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_loss_match_jax(case):
    jp, tp, y, z = _build(CASES[case])
    funcs = {b.attn.attn_func for b in tp.model.prior.transformer.blocks}
    if tp.model.prime_prior is not None:
        funcs |= {b.attn.attn_func
                  for b in tp.model.prime_prior.transformer.blocks}
    if case.startswith("order") or case == "prime_spread":
        assert funcs & {4, 5}
    jloss, jm = jp.model.z_forward(jp.params, jnp.asarray(z),
                                   y=jnp.asarray(y), get_preds=True)
    with torch.no_grad():
        tloss, tm = tp.model.z_forward(torch.as_tensor(z),
                                       y=torch.as_tensor(np.asarray(y)),
                                       get_preds=True)
    assert float(tloss) == pytest.approx(float(jloss), abs=1e-5)
    np.testing.assert_allclose(tm["preds"].numpy(), np.asarray(jm["preds"]),
                               rtol=1e-4, atol=1e-4)
    for key in ("prime_loss", "gen_loss"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), abs=1e-5)


def test_copy_input_reads_the_codes_not_the_lyrics():
    """With copy_input the lyric part of y does not reach the loss."""
    _, tp, y, z = _build(CASES["copy_input"])
    y2 = np.array(y, copy=True)
    y2[:, -tp.model.n_tokens:] = (y2[:, -tp.model.n_tokens:] + 5) % 79
    with torch.no_grad():
        a, _ = tp.model.z_forward(torch.as_tensor(z), y=torch.as_tensor(y))
        b, _ = tp.model.z_forward(torch.as_tensor(z), y=torch.as_tensor(y2))
    assert float(a) == float(b)


@pytest.mark.parametrize("key", ["pos_init", "prime_pos_init"])
def test_pos_init_is_still_refused(key):
    tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    with pytest.raises(NotImplementedError, match=key):
        tmm.make_prior(thp.setup_hparams("teeny", dict(TOP, **{key: True})),
                       tvq, "cpu")


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_summary_patterns_do_not_decode(package):
    """Attn order 4 ([1, 5]): both packages refuse the caches of its
    summary-spread layers, with the same reason."""
    cfg = dict(CASES["order4_spread"])
    if package == "jax":
        jvq = jmm.make_vqvae(jhp.setup_hparams("teeny", dict(VQ)))
        jp = jmm.make_prior(jhp.setup_hparams("teeny", cfg), jvq)
        with pytest.raises(NotImplementedError, match="summary-spread"):
            jp.model.prior.init_decode_caches(jp.params["prior"], N)
        return
    tvq = tmm.make_vqvae(thp.setup_hparams("teeny", dict(VQ)), "cpu")
    tp = tmm.make_prior(thp.setup_hparams("teeny", cfg), tvq, "cpu")
    with pytest.raises(NotImplementedError,
                       match="attn_func 5: summary-spread"):
        tp.model.prior.init_decode_caches(N, "cpu")
