"""An upsampler prior's teacher-forced logits in plain float32 PyTorch,
written from upstream's jukebox/prior/prior.py (a level below the top: its
x conditioning from the codes of the level above, its labels without the
timing signal), jukebox/prior/conditioners.py (Conditioner),
jukebox/vqvae/encdec.py (DecoderConvBock) and jukebox/vqvae/resnet.py
(Resnet1D, ResConv1DBlock), with the transformer's layers, attention
patterns and output head of reference/prior.py.

`layout(cfg)` lists the parameters (name, shape) of the upsampler that
`cfg["hparams"]` describes, under the names of the port's modules
(`conditioner_blocks.0.*`, the v2 `y_emb`, `prior.*`), so that one set of
drawn weights feeds both sides. `x_cond(w, cfg, z_up)` is the conditioner
over the codes of the level above; `logits(w, cfg, tokens, z_up, y)` runs
one window: the start embedding (artist and bag-of-words genre), the codes'
embedding, positions and x conditioning, the transformer, x conditioning
again, and the output head shared with the code table. Each call holds its
rows whole: a caller with a window of many rows passes them a few at a
time. The caller sets torch.backends.*.allow_tf32 to False.

Departures from upstream: none in the mathematics. Sequences shorter than
a window are padded at the end; every pattern is causal, so the padding
changes no logit before it. `lowp` (a control) rounds the transformer's
products alone, as the program stages the transformer alone for its
decode; the conditioner stays in float32.
"""

import torch
import torch.nn.functional as F

from benchmark.reference import prior as ref


def _conv_keys(cfg):
    """[(name, shape)] of the conditioner: the code table, DecoderConvBock's
    projection, down_t x (Resnet1D of cond_depth blocks, the transposed
    conv), the LayerNorm."""
    hp = cfg["hparams"]
    W, C = hp["prior_width"], hp["cond_width"]
    C_in = int(hp["cond_m_conv"] * C)
    up = hp["level"] + 1
    down, k = hp["downs_t"][up], 2 * hp["strides_t"][up]
    p = "conditioner_blocks.0."
    out = [(p + "x_emb.weight", (hp["l_bins"], W)),
           (p + "cond.proj.w", (C, W, 3)), (p + "cond.proj.b", (C,))]
    for i in range(down):
        q = f"{p}cond.ups.{i}."
        for d in range(hp["cond_depth"]):
            r = f"{q}resnet.blocks.{d}."
            out += [(r + "conv_dil.w", (C_in, C, 3)), (r + "conv_dil.b", (C_in,)),
                    (r + "conv_1x1.w", (C, C_in, 1)), (r + "conv_1x1.b", (C,))]
        c_out = W if i == down - 1 else C
        out += [(q + "conv_up.w", (C, c_out, k)), (q + "conv_up.b", (c_out,))]
    return out + [(p + "ln.g", (W,)), (p + "ln.b", (W,))]


def layout(cfg):
    """[(name, shape)] of every parameter of the upsampler, in a fixed
    order: the conditioner, the labels' start embedding, then the prior
    (reference/prior.py's names)."""
    hp = cfg["hparams"]
    if ref.is_top(hp):
        raise ValueError("a top prior has no conditioner: reference/prior.py")
    if hp.get("single_enc_dec") or hp.get("n_tokens"):
        raise NotImplementedError("an upsampler takes no lyric tokens")
    W = hp["prior_width"]
    out = _conv_keys(cfg)
    if hp["labels"]:
        genre_bins, artist_bins = hp["y_bins"]
        out += [("y_emb.bow_genre_emb.emb.weight", (genre_bins, W)),
                ("y_emb.artist_emb.emb.weight", (artist_bins, W))]
    top = dict(cfg, hparams=dict(hp, level=hp["levels"] - 1, labels=False))
    return out + ref.layout(top)


def _dilations(hp):
    """Resnet1D's dilations: growth_rate ** (depth % cycle)."""
    g, cyc = hp["cond_dilation_growth_rate"], hp["cond_dilation_cycle"]
    return [g ** (d if cyc is None else d % cyc)
            for d in range(hp["cond_depth"])]


def x_cond(w, cfg, z_up):
    """The conditioner over z_up [N, T] (codes of the level above) ->
    [N, T * stride ** down_t, W]: the code table, a kernel-3 projection to
    cond_width, then per upsampling Resnet1D (ReLU, a dilated kernel-3
    conv, ReLU, a 1x1 conv, residual at res_scale) and a transposed conv of
    kernel 2 * stride, stride `stride`, padding stride // 2; then a
    LayerNorm over the width."""
    hp = cfg["hparams"]
    up = hp["level"] + 1
    down, stride = hp["downs_t"][up], hp["strides_t"][up]
    p = "conditioner_blocks.0."
    scale = (hp["cond_depth"] ** -0.5 if hp.get("cond_res_scale")
             else 1.0)
    x = w[p + "x_emb.weight"][z_up].transpose(1, 2)
    x = F.conv1d(x, w[p + "cond.proj.w"], w[p + "cond.proj.b"], padding=1)
    for i in range(down):
        q = f"{p}cond.ups.{i}."
        for d, dil in enumerate(_dilations(hp)):
            r = f"{q}resnet.blocks.{d}."
            h = F.conv1d(torch.relu(x), w[r + "conv_dil.w"],
                         w[r + "conv_dil.b"], padding=dil, dilation=dil)
            h = F.conv1d(torch.relu(h), w[r + "conv_1x1.w"],
                         w[r + "conv_1x1.b"])
            x = x + scale * h
        x = F.conv_transpose1d(x, w[q + "conv_up.w"], w[q + "conv_up.b"],
                               stride=stride, padding=stride // 2)
    return ref.layer_norm(x.transpose(1, 2), w[p + "ln.g"], w[p + "ln.b"])


def start_embedding(w, hp, y):
    """y [N, 4 + max_bow_genre_size] (total_length, offset, length,
    artist, genres, -1 for none) -> [N, 1, W]: the artist's row plus the
    genres' rows (upstream LabelConditioner; no timing signal below the
    top)."""
    artist, genre = y[:, 3:4], y[:, 4:4 + hp["max_bow_genre_size"]]
    mask = (genre >= 0).float()[..., None]
    return (w["y_emb.bow_genre_emb.emb.weight"][genre.clamp(min=0)]
            * mask).sum(dim=1, keepdim=True) \
        + w["y_emb.artist_emb.emb.weight"][artist]


def logits(w, cfg, tokens, z_up, y, lowp=None, cond=None):
    """Teacher-forced logits [N, n_ctx, l_bins] of the window's codes
    tokens [N, n] (n <= n_ctx; shorter streams are padded), conditioned on
    z_up [N, n_ctx / cond_downsample] and the labels y [N, 4 +
    max_bow_genre_size]. lowp: the transformer's products in that dtype's
    precision (a control). cond: x_cond(w, cfg, z_up) where the caller has
    it already."""
    hp = cfg["hparams"]
    L = hp["n_ctx"]
    N, n = tokens.shape
    if n < L:
        tokens = torch.cat([tokens, tokens.new_zeros((N, L - n))], dim=1)
    if cond is None:
        cond = x_cond(w, cfg, z_up)
    emb = w["prior.x_emb.weight"][tokens]
    emb = torch.cat([start_embedding(w, hp, y), emb[:, :-1]], dim=1)
    h = emb + w["prior.pos_emb.pos_emb"][None] + cond
    h = ref.transformer(w, hp, h, lowp) + cond
    return h @ w["prior.x_emb.weight"].t()
