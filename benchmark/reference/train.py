"""A top prior's fine-tuning step in plain float32 PyTorch: the VQ-VAE's
top-level encoder and nearest-code bottleneck (upstream jukebox/vqvae/
encdec.py, resnet.py, bottleneck.py), the prior's loss in bits per dim
(upstream jukebox/prior/prior.py: the lyric and code parts weighted by
prime_loss_fraction and their share of the stream), its gradients by
autograd, and upstream's Adam (jukebox/utils/fp16.py: the gradient divided
by max(1, norm / clip), bias-corrected moments, weight decay inside the
step), with the learning rate warmed up linearly (jukebox/train.py).

Departures: the gradient of a batch is summed row by row (each row's loss
weighted by 1 / rows, so the sum is the batch mean's gradient) and each
layer is recomputed in the backward pass, to fit the card; moments stay
float32 where upstream's fp16 option rounds them.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import prior as ref

LN2 = math.log(2.0)


def encoder_layout(vq, level):
    """[(name, shape)] of the level's encoder and codebook, vq the VQ-VAE's
    hparams (levels, downs_t, strides_t, emb_width, width, depth, m_conv,
    hvqvae_multipliers, l_bins)."""
    mult = vq["hvqvae_multipliers"][level]
    width, depth = vq["width"] * mult, vq["depth"] * mult
    ms = int(vq["m_conv"] * width)
    out = []
    for i in range(level + 1):
        p = f"encoders.{level}.level_blocks.{i}."
        for j in range(vq["downs_t"][i]):
            n_in = (1 if i == 0 else vq["emb_width"]) if j == 0 else width
            q = f"{p}downs.{j}."
            out += [(q + "conv_down.w", (width, n_in, 2 * vq["strides_t"][i])),
                    (q + "conv_down.b", (width,))]
            for k in range(depth):
                r = f"{q}resnet.blocks.{k}."
                out += [(r + "conv_dil.w", (ms, width, 3)),
                        (r + "conv_dil.b", (ms,)),
                        (r + "conv_1x1.w", (width, ms, 1)),
                        (r + "conv_1x1.b", (width,))]
        out += [(p + "proj.w", (vq["emb_width"], width, 3)),
                (p + "proj.b", (vq["emb_width"],))]
    out.append((f"bottleneck.level_blocks.{level}.k",
                (vq["l_bins"], vq["emb_width"])))
    return out


def encode(w, vq, level, x):
    """Audio x [N, T, 1] -> the level's codes [N, T / hop]."""
    mult = vq["hvqvae_multipliers"][level]
    depth = vq["depth"] * mult
    h = x.transpose(1, 2)
    for i in range(level + 1):
        p = f"encoders.{level}.level_blocks.{i}."
        s = vq["strides_t"][i]
        for j in range(vq["downs_t"][i]):
            q = f"{p}downs.{j}."
            h = F.conv1d(h, w[q + "conv_down.w"], w[q + "conv_down.b"],
                         stride=s, padding=s // 2)
            for k in range(depth):
                dil = vq["dilation_growth_rate"] ** (
                    k if vq["dilation_cycle"] is None
                    else k % vq["dilation_cycle"])
                r = f"{q}resnet.blocks.{k}."
                a = F.conv1d(torch.relu(h), w[r + "conv_dil.w"],
                             w[r + "conv_dil.b"], padding=dil, dilation=dil)
                h = h + F.conv1d(torch.relu(a), w[r + "conv_1x1.w"],
                                 w[r + "conv_1x1.b"])
        h = F.conv1d(h, w[p + "proj.w"], w[p + "proj.b"], padding=1)
    N, C, T = h.shape
    flat = h.transpose(1, 2).reshape(-1, C)
    k = w[f"bottleneck.level_blocks.{level}.k"]
    d = (flat * flat).sum(-1, keepdim=True) - 2 * flat @ k.t() \
        + (k * k).sum(-1)[None]
    return d.argmin(dim=-1).reshape(N, T)


def loss(w, cfg, z, y, recompute=True, lowp=None):
    """The single_enc_dec top prior's training loss (bits per dim) of codes
    z [N, n_ctx] with labels and lyrics y, as upstream's z_forward weighs
    its parts. lowp: every product of the layers in that dtype's precision
    (rounded)."""
    hp = cfg["hparams"]
    N = z.shape[0]
    W, n_tok = hp["prior_width"], hp["n_tokens"]
    n_labels = 4 + hp["max_bow_genre_size"]
    lyr = y[:, n_labels:]
    x = torch.cat([lyr, z + hp["n_vocab"]], dim=1)
    start, tpos = ref.label_conditioning(w, hp, y[:, :n_labels])
    cond = torch.cat([tpos.new_zeros((N, n_tok, W)), tpos], dim=1)
    emb = w["prior.x_emb.weight"][x]
    h = torch.cat([start, emb[:, :-1]], dim=1) + w["prior.pos_emb.pos_emb"][
        None] + cond
    for d in range(hp["prior_depth"]):
        if recompute:
            h = checkpoint(ref.layer, w, hp, d, h, lowp, use_reentrant=False)
        else:
            h = ref.layer(w, hp, d, h, lowp)
    logits = (h + cond) @ w["prior.x_emb.weight"].t()

    def bpd(lg, t):
        return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                               t.reshape(-1)) / LN2
    prime, gen = bpd(logits[:, :n_tok], x[:, :n_tok]), bpd(
        logits[:, n_tok:], x[:, n_tok:])
    total = n_tok + hp["n_ctx"]
    return (hp["prime_loss_fraction"] * prime * n_tok / total
            + gen * hp["n_ctx"] / total)


def grads(w, names, cfg, z, y, lowp=None):
    """(batch mean loss, {name: gradient}) summed row by row."""
    g = {n: torch.zeros_like(w[n]) for n in names}
    total = 0.0
    N = z.shape[0]
    for r in range(N):
        leaves = {n: w[n].detach().requires_grad_(True) for n in names}
        wr = dict(w, **leaves)
        lo = loss(wr, cfg, z[r:r + 1], y[r:r + 1], lowp=lowp) / N
        lo.backward()
        total += float(lo.detach())
        for n in names:
            g[n] += leaves[n].grad
    return total, g


def lr_at(tr, it):
    """Upstream's warmed-up learning rate at step it (no decay in the
    first steps)."""
    return tr["lr"] * min(it / tr["lr_warmup"], 1.0)


FLOAT16_MAX = 65504.0


def fp16_stored(x):
    """x as upstream's fp16 optimizer state keeps it between steps: fp16
    values under one per-tensor scale 1e-8 + max|x| / 65504."""
    s = 1e-8 + x.abs().max() / FLOAT16_MAX
    return (x / s).half().float() * s


@torch.no_grad()
def adam(params, g, state, it, lr, tr):
    """Upstream's Adam step in place: g divided by max(1, |g| / clip),
    bias-corrected moments, weight decay inside the step; with
    tr["fp16_opt"] the moments are kept in fp16 between steps
    (upstream's FP16FusedAdam)."""
    gn = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
    div = torch.clamp(gn / tr["clip"], min=1.0)
    b1, b2 = tr["beta1"], tr["beta2"]
    step_size = lr * math.sqrt(1 - b2 ** it) / (1 - b1 ** it)
    for n, p in params.items():
        gi = g[n] / div
        m = state["m"].setdefault(n, torch.zeros_like(p))
        v = state["v"].setdefault(n, torch.zeros_like(p))
        m.mul_(b1).add_((1 - b1) * gi)
        v.mul_(b2).add_((1 - b2) * gi * gi)
        p.sub_(step_size * (m / (torch.sqrt(v) + tr["eps"])
                            + tr["weight_decay"] * p))
        if tr.get("fp16_opt"):
            m.copy_(fp16_stored(m))
            v.copy_(fp16_stored(v))
        state.setdefault("g1", {})
        if it == 1:
            state["g1"][n] = gi.clone()
    return float(gn)


def moving_parts(g_ref, floor=1e-3):
    """{leaf: mask} of the elements whose reference gradient is at least
    `floor` x the median leaf's root mean square gradient, for the leaves
    that hold any: the others (a key's bias under softmax, an embedding's
    rows no input reads) move under Adam by round-off alone."""
    rms = {n: float(torch.sqrt(torch.mean(t.float() ** 2)))
           for n, t in g_ref.items()}
    cut = floor * float(np.median(list(rms.values())))
    out = {}
    for n, t in g_ref.items():
        mask = t.float().abs() >= cut
        if bool(mask.any()):
            out[n] = mask
    return out


def leaf_gaps(prog, ref_, keep):
    """(worst leaf's gap, leaves compared, the worst leaf) over the
    moving parts `keep` ({leaf: mask}): |norm(prog) - norm(ref)| over the
    larger of the part's reference norm and the median part's."""
    norms = {n: float(torch.linalg.vector_norm(ref_[n].float()[m]))
             for n, m in keep.items()}
    med = float(np.median(list(norms.values())))
    worst, at = 0.0, None
    for n, r in norms.items():
        p = float(torch.linalg.vector_norm(prog[n].float()[keep[n]]))
        gap = abs(p - r) / max(r, med)
        if gap > worst:
            worst, at = gap, n
    return worst, len(norms), at
