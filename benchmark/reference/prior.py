"""A Jukebox prior's teacher-forced logits in plain float32 PyTorch,
written from upstream's jukebox/prior/autoregressive.py,
jukebox/transformer/transformer.py, factored_attention.py and
jukebox/prior/conditioners.py.

`layout(cfg)` lists the parameters (name, shape) of the top prior that
`cfg["hparams"]` describes, under the names of the port's modules, so that
one set of drawn weights feeds both sides. `logits(w, cfg, tokens, y)`
runs the whole context of one window: label conditioning (artist,
bag-of-words genre, the timing signal), the lyric prefix of a
single_enc_dec prior, the transformer with each layer's attention
pattern, and the output head. An upsampler (its conditioner over the codes
of the level above) is not in the reference. The caller sets
torch.backends.*.allow_tf32 to False.

Departures from upstream: none in the mathematics. Sequences shorter than
a window are padded at the end; every pattern is causal, so the padding
changes no logit before it.
"""

import math

import torch

NEG = -1e9

# layer depth -> attention pattern (upstream transformer.py, attn_order)
ATTN_ORDERS = {
    0: lambda d: 0,
    1: lambda d: [1, 2][d % 2],
    2: lambda d: [1, 2, 3][d % 3],
    3: lambda d: [1, 4][d % 2],
    6: lambda d: [1, 2, 3, 6][d % 4],
    7: lambda d: [*[1, 2, 3] * 5, 6][d % 16],
    8: lambda d: [1, 2, 3, 1, 2, 3, 1, 2, 3, 6][d % 10],
    9: lambda d: [1, 2, 3, 0][d % 4],
    12: lambda d: ([7, 7, 0][d % 3] if d % 16 == 15 else [1, 2, 3][d % 3]),
}


def attn_func(hp, d):
    return ATTN_ORDERS[hp["attn_order"]](d)


def geometry(hp):
    """(sequence length, token bins, block length) of the prior's
    transformer: a single_enc_dec prior runs the lyric tokens and the codes
    as one stream over both vocabularies."""
    sed = hp.get("single_enc_dec", False)
    L = hp["n_ctx"] + (hp["n_tokens"] if sed else 0)
    bins = hp["l_bins"] + (hp["n_vocab"] if sed else 0)
    return L, bins, L // hp["blocks"]


def is_top(hp):
    return hp["level"] == hp["levels"] - 1


def layout(cfg):
    """[(name, shape)] of every parameter of the prior, in a fixed order."""
    hp = cfg["hparams"]
    W = hp["prior_width"]
    out = []
    if not is_top(hp):
        raise NotImplementedError("an upsampler is not in the reference")
    if hp["labels"]:
        genre_bins, artist_bins = hp["y_bins"]
        out += [("y_emb.bow_genre_emb.emb.weight", (genre_bins, W)),
                ("y_emb.artist_emb.emb.weight", (artist_bins, W))]
        for k in ("total_length_emb", "absolute_pos_emb",
                  "relative_pos_emb"):
            out.append((f"y_emb.{k}.emb.weight", (hp["t_bins"], W)))
    L, bins, _ = geometry(hp)
    out += [("prior.x_emb.weight", (bins, W)),
            ("prior.pos_emb.pos_emb", (L, W))]
    A, M = int(hp["m_attn"] * W), int(hp["m_mlp"] * W)
    for d in range(hp["prior_depth"]):
        if attn_func(hp, d) in (4, 5, 6):
            raise NotImplementedError("patterns 4-6 are not in the reference")
        q = f"prior.transformer.blocks.{d}."
        out += [(q + "attn.c_attn.w", (W, 3 * A)),
                (q + "attn.c_attn.b", (3 * A,)),
                (q + "attn.c_proj.w", (A, W)), (q + "attn.c_proj.b", (W,)),
                (q + "ln_0.g", (W,)), (q + "ln_0.b", (W,)),
                (q + "mlp.c_fc.w", (W, M)), (q + "mlp.c_fc.b", (M,)),
                (q + "mlp.c_proj.w", (M, W)), (q + "mlp.c_proj.b", (W,)),
                (q + "ln_1.g", (W,)), (q + "ln_1.b", (W,))]
    return out


# -- building blocks ----------------------------------------------------------

def layer_norm(x, g, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def rounded(x, dtype):
    """x with its values rounded to `dtype` under one per-tensor scale
    (its largest magnitude at the type's largest finite value); the
    gradient passes unchanged. The controls compute in this precision."""
    top = torch.finfo(dtype).max
    s = x.detach().abs().amax().clamp(min=1e-30) / top
    q = (x.detach() / s).to(dtype).float() * s
    return x + (q - x).detach()


def int8_columns(x):
    """x [in, out] with each output column rounded to int8 under a scale of
    its own (its largest magnitude at 127)."""
    s = x.abs().amax(0, keepdim=True).clamp(min=1e-12) / 127
    return torch.round(x / s).clamp(-127, 127) * s


PRODUCTS = ("attn.c_attn.w", "attn.c_proj.w", "mlp.c_fc.w", "mlp.c_proj.w")


def int8_weights(w):
    """w with every layer's product weights rounded by int8_columns."""
    return {n: int8_columns(t) if n.endswith(PRODUCTS) else t
            for n, t in w.items()}


def mm(a, b, lowp=None):
    """a @ b, with both inputs rounded to `lowp` when given."""
    if lowp is None:
        return a @ b
    return rounded(a, lowp) @ rounded(b, lowp)


def _attend(q, k, v, n_head, mask):
    """q [B, Lq, S], k, v [B, Lk, S]; mask [Lq, Lk] of 0/1 or None. q and k
    each scaled by hd ** -0.25 (upstream's split scale)."""
    B, Lq, S = q.shape
    hd = S // n_head
    s = 1.0 / math.sqrt(math.sqrt(hd))

    def heads(x):
        return x.reshape(B, x.shape[1], n_head, hd).transpose(1, 2)
    w = torch.matmul(heads(q) * s, (heads(k) * s).transpose(-1, -2))
    if mask is not None:
        w = w * mask + NEG * (1 - mask)
    w = torch.softmax(w, dim=-1)
    o = torch.matmul(w, heads(v))
    return o.transpose(1, 2).reshape(B, Lq, S)


def attention(q, k, v, n_head, func, blocks, prime_len):
    """Upstream factored_attention.py's full-context patterns over
    q, k, v [B, L, S]: 0 dense causal, 1 within the block, 2 the same
    column of every block so far, 3 the whole previous block, 7 the
    block-aligned lyric prefix."""
    B, L, S = q.shape
    dev = q.device
    if func == 0:
        return _attend(q, k, v, n_head,
                       torch.tril(torch.ones(L, L, device=dev)))
    bc = L // blocks
    if func == 1:
        o = _attend(q.reshape(-1, bc, S), k.reshape(-1, bc, S),
                    v.reshape(-1, bc, S), n_head,
                    torch.tril(torch.ones(bc, bc, device=dev)))
        return o.reshape(B, L, S)
    if func == 2:
        def cols(x):
            return x.reshape(B, blocks, bc, S).transpose(1, 2).reshape(
                B * bc, blocks, S)
        o = _attend(cols(q), cols(k), cols(v), n_head,
                    torch.tril(torch.ones(blocks, blocks, device=dev)))
        return o.reshape(B, bc, blocks, S).transpose(1, 2).reshape(B, L, S)
    if func == 3:
        def prev(x):
            xb = x.reshape(B, blocks, bc, S)
            return torch.cat([torch.zeros_like(xb[:, :1]), xb[:, :-1]],
                             dim=1).reshape(B * blocks, bc, S)
        o = _attend(q.reshape(B * blocks, bc, S), prev(k), prev(v), n_head,
                    None)
        return o.reshape(B, L, S)
    if func == 7:
        pl = (prime_len // blocks + 1) * blocks
        return _attend(q, k[:, :pl], v[:, :pl], n_head,
                       torch.tril(torch.ones(L, pl, device=dev)))
    raise NotImplementedError(f"pattern {func}")


def layer(w, hp, d, h, lowp=None):
    """Block d of the pre-LN residual stack over h [B, L, W]; lowp: every
    product's inputs (and q, k, v) rounded to that dtype (a control)."""
    A = int(hp["m_attn"] * hp["prior_width"])
    prime_len = hp["n_tokens"] if hp.get("single_enc_dec") else None
    p = f"prior.transformer.blocks.{d}."
    x = layer_norm(h, w[p + "ln_0.g"], w[p + "ln_0.b"])
    qkv = mm(x, w[p + "attn.c_attn.w"], lowp) + w[p + "attn.c_attn.b"]
    q, k, v = qkv[..., :A], qkv[..., A:2 * A], qkv[..., 2 * A:]
    if lowp is not None:
        q, k, v = (rounded(t, lowp) for t in (q, k, v))
    o = attention(q, k, v, hp["heads"], attn_func(hp, d), hp["blocks"],
                  prime_len)
    a = mm(o, w[p + "attn.c_proj.w"], lowp) + w[p + "attn.c_proj.b"]
    x = layer_norm(h + a, w[p + "ln_1.g"], w[p + "ln_1.b"])
    m = quick_gelu(mm(x, w[p + "mlp.c_fc.w"], lowp) + w[p + "mlp.c_fc.b"])
    return h + a + mm(m, w[p + "mlp.c_proj.w"], lowp) + w[p + "mlp.c_proj.b"]


def transformer(w, hp, h, lowp=None):
    """The pre-LN residual stack over h [B, L, W]."""
    for d in range(hp["prior_depth"]):
        h = layer(w, hp, d, h, lowp)
    return h


def _range_emb(table, n_time, bins, lo, hi, start, end=None, clamp=False):
    """Upstream RangeEmbedding: [start, end] interpolated over n_time
    positions, binned over [lo, hi), embedded."""
    start = start.float()
    if end is not None:
        if clamp:
            end = end.clamp(lo, hi)
        end = end.float()
    if n_time != 1:
        interp = (torch.arange(n_time, dtype=torch.float32,
                               device=start.device) / n_time)[None]
        pos = start + (end - start) * interp
    else:
        pos = start
    norm = (pos - lo) / (hi - lo)
    idx = torch.floor(bins * norm).long().clamp(0, bins - 1)
    return table[idx]


def label_conditioning(w, hp, y):
    """y [N, 4 + max_bow_genre_size] (total_length, offset, length, artist,
    genres, -1 for none) -> (start embedding [N, 1, W], the timing signal
    [N, n_ctx, W])."""
    artist, genre = y[:, 3:4], y[:, 4:]
    start = w["y_emb.artist_emb.emb.weight"][artist]
    mask = (genre >= 0).float()[..., None]
    start = (w["y_emb.bow_genre_emb.emb.weight"][genre.clamp(min=0)]
             * mask).sum(dim=1, keepdim=True) + start
    total, offset, length = y[:, 0:1], y[:, 1:2], y[:, 2:3]
    t0, t1, tot = offset.float(), (offset + length).float(), total.float()
    sr, tb, n = hp["sr"], hp["t_bins"], hp["n_ctx"]
    pos = (_range_emb(w["y_emb.total_length_emb.emb.weight"], 1, tb,
                      hp["min_duration"] * sr, hp["max_duration"] * sr, tot)
           + _range_emb(w["y_emb.absolute_pos_emb.emb.weight"], n, tb, 0.0,
                        hp["max_duration"] * sr, t0, t1)
           + _range_emb(w["y_emb.relative_pos_emb.emb.weight"], n, tb, 0.0,
                        1.0, t0 / tot, t1 / tot, clamp=True))
    return start, pos


def logits(w, cfg, tokens, y, lowp=None):
    """Teacher-forced logits [N, L, bins] of the window's stream tokens
    [N, L] (a single_enc_dec prior's: the lyric tokens, then the codes
    shifted past the lyric vocabulary; shorter streams are padded) and its
    labels y [N, 4 + genres (+ lyric tokens)]. lowp: the transformer's products in that dtype's precision (a
    control)."""
    hp = cfg["hparams"]
    L, bins, _ = geometry(hp)
    N, n = tokens.shape
    if n < L:
        tokens = torch.cat([tokens, tokens.new_zeros((N, L - n))], dim=1)
    W = hp["prior_width"]
    n_labels = 4 + hp["max_bow_genre_size"]
    start, cond = label_conditioning(w, hp, y[:, :n_labels])
    if hp.get("single_enc_dec"):
        cond = torch.cat([cond.new_zeros((N, hp["n_tokens"], W)), cond],
                         dim=1)
    emb = w["prior.x_emb.weight"][tokens]
    emb = torch.cat([start, emb[:, :-1]], dim=1)
    h = emb + w["prior.pos_emb.pos_emb"][None] + cond
    h = transformer(w, hp, h, lowp) + cond
    return h @ w["prior.x_emb.weight"].t()
