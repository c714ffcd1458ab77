"""VQ-VAE of the PyTorch port against jukebox_tpu on the CPU, fp32, on the
same encoder and decoder weights and codebooks.

Decode: random codes at every level; tolerance 1e-4 abs / 1e-4 rel: a few
fp32 conv layers deep, both sides exact fp32 (JAX at HIGHEST precision),
differing in summation order.

Encode: random audio, codes of every level range; the codes must be equal.
The inputs are ties-free: at every position the nearest code is nearer than
the second by more than 1e-6 of the largest distance, above the fp32
rounding of the distances (~1e-7 relative) in which the two encoders
differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jukebox_tpu.models.encdec import BlockCfg as JBlockCfg
from jukebox_tpu.models.vqvae import VQVAE as JVQVAE
from jukebox_tpu_torch.models.encdec import BlockCfg
from jukebox_tpu_torch.models.vqvae import VQVAE
from jukebox_tpu_torch.utils.convert import from_jax_params, vqvae_tree

torch.set_num_threads(1)

CFG = dict(levels=3, downs_t=(2, 1, 1), strides_t=(2, 2, 2), emb_width=8,
           l_bins=16)
BLOCK = dict(width=8, depth=2, m_conv=1.0, dilation_growth_rate=3,
             reverse_decoder_dilation=True)


@pytest.fixture(scope="module")
def models():
    jm = JVQVAE(input_shape=(128, 1), mu=0.99, commit=0.02, spectral=0.0,
                multispectral=1.0, multipliers=(2, 1, 1),
                block=JBlockCfg(**BLOCK), **CFG)
    params = jm.init(jax.random.key(0))
    rng = np.random.RandomState(1)
    state = {"level_blocks": [
        {"k": jnp.asarray(rng.randn(CFG["l_bins"], CFG["emb_width"]),
                          jnp.float32)} for _ in range(CFG["levels"])]}
    tm = VQVAE((128, 1), CFG["levels"], CFG["downs_t"], CFG["strides_t"],
               CFG["emb_width"], CFG["l_bins"], (2, 1, 1), BlockCfg(**BLOCK),
               device="cpu")
    from_jax_params(tm, vqvae_tree(jax.tree_util.tree_map(np.asarray, params),
                                   state))
    return jm, params, state, tm


@pytest.mark.parametrize("level", [0, 1, 2])
def test_decode_level(models, level):
    jm, params, state, tm = models
    rng = np.random.RandomState(10 + level)
    zs = [rng.randint(0, CFG["l_bins"], (2, n)) for (n,) in jm.z_shapes]
    ref = jm.decode(params, state, [jnp.asarray(z) for z in zs[level:]],
                    start_level=level)
    out = tm.decode([torch.from_numpy(z) for z in zs[level:]],
                    start_level=level, bs_chunks=2)
    assert out.shape == (2, 128, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("start_level,end_level", [(0, 3), (1, 3), (2, 3),
                                                   (0, 1)])
def test_encode_levels(models, start_level, end_level):
    jm, params, state, tm = models
    x = np.random.RandomState(20 + start_level).uniform(
        -1, 1, (2, 128, 1)).astype(np.float32)
    ref = jm.encode(params, state, jnp.asarray(x), start_level=start_level,
                    end_level=end_level)
    out = tm.encode(torch.from_numpy(x), start_level, end_level, bs_chunks=2)
    assert len(out) == len(ref) == end_level - start_level
    for level, (o, r) in enumerate(zip(out, ref), start_level):
        with torch.no_grad():
            lat = tm.encoders[level](torch.from_numpy(x)).reshape(-1, 8)
            k = tm.bottleneck.level_blocks[level].k
            d = torch.sort(torch.cdist(lat, k) ** 2, dim=-1).values
        assert float((d[:, 1] - d[:, 0]).min()) > 1e-6 * float(d.max())
        assert o.shape == (2, 128 // (2 ** (level + 2)))
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
