"""Lyric-music alignment from attention weights (counterpart of
jukebox_tpu/align.py). Re-runs the top prior's teacher-forced forward per
hop with attention recording at (alignment_layer, alignment_head), and
stitches the per-hop (n_ctx, n_tokens) attention maps into a full
(total_length, n_lyric_chars) alignment using each hop's lyric-window source
indices (align.py:15-83). The forward runs where the prior's weights are;
its failure raises.

    python -m jukebox_tpu_torch.align 1b_lyrics --logdir=out --levels=3 \
        --sample_length_in_seconds=24 --hop_fraction=0.5,0.5,0.125

reads {logdir}/level_0/data.jkb (a sample run's codes and labels), writes
data_align.jkb beside it and that level's html with the alignment.
"""

import pickle

import numpy as np

from jukebox_tpu_torch.hparams import Hyperparams
from jukebox_tpu_torch.utils.cli import fire
from jukebox_tpu_torch.utils.sample_utils import get_starts


def get_alignment(x, zs, labels, prior, fp16, hps):
    """One alignment [total_length, len(full_tokens)] per sample of the top
    level's codes zs[-1]. The top level is hps.levels - 1, or the last of
    zs when hps has no levels."""
    level = hps.get("levels", len(zs)) - 1
    n_ctx, n_tokens = prior.n_ctx, prior.n_tokens
    z = np.asarray(zs[level])
    bs, total_length = z.shape[0], z.shape[1]
    if total_length < n_ctx:
        padding_length = n_ctx - total_length
        z = np.concatenate(
            [z, np.zeros((bs, n_ctx - total_length), dtype=z.dtype)], axis=1)
        total_length = z.shape[1]
    else:
        padding_length = 0

    hop_length = int(hps.hop_fraction[level] * prior.n_ctx)
    alignment_head, alignment_layer = prior.alignment_head, prior.alignment_layer
    attn_layers = {alignment_layer}
    alignment_hops, indices_hops = {}, {}
    for start in get_starts(total_length, n_ctx, hop_length):
        end = start + n_ctx
        y, indices_hop = prior.get_y(labels, start, get_indices=True)
        assert len(indices_hop) == bs
        for indices in indices_hop:
            assert len(indices) == n_tokens
        # one batched attention-recording forward per hop (align.py:42-59)
        w_hop = prior.z_forward(z[:, start:end], [], y, fp16=fp16,
                                get_attn_weights=attn_layers,
                                attn_head=alignment_head)
        assert len(w_hop) == 1
        alignment_hop = w_hop[0].float().cpu().numpy()
        assert alignment_hop.shape == (bs, n_ctx, n_tokens)
        indices_hops[start] = indices_hop
        alignment_hops[start] = alignment_hop

    # stitch hops into the full alignment per item
    alignments = []
    for item in range(bs):
        full_tokens = labels["info"][item]["full_tokens"]
        alignment = np.zeros((total_length, len(full_tokens) + 1))
        for start in reversed(get_starts(total_length, n_ctx, hop_length)):
            end = start + n_ctx
            alignment_hop = alignment_hops[start][item]
            indices = indices_hops[start][item]
            alignment[start:end, indices] = alignment_hop
        # drop token padding and the trailing pad index
        alignment = alignment[: total_length - padding_length, :-1]
        alignments.append(alignment)
    return alignments


def save_alignment(model, device, hps):
    """The alignment of a sample run's codes ({hps.logdir}/level_0/data.jkb)
    by the model's top prior: data_align.jkb and that level's html."""
    from jukebox_tpu_torch.models.make_models import make_model
    from jukebox_tpu_torch.save_html import save_html

    vqvae, priors = make_model(model, hps, device, levels=[-1])
    logdir = f"{hps.logdir}/level_0"
    with open(f"{logdir}/data.jkb", "rb") as f:
        data = pickle.load(f)
    fp16 = model != "1b_lyrics"
    data["alignments"] = get_alignment(data["x"], data["zs"],
                                       data["labels"][-1], priors[-1], fp16,
                                       hps)
    with open(f"{logdir}/data_align.jkb", "wb") as f:
        pickle.dump(data, f)
    save_html(logdir, data["x"], data["zs"], data["labels"][-1],
              data["alignments"], hps)


def run(model, port=29500, device="cuda", **kwargs):
    hps = Hyperparams(**kwargs)
    save_alignment(model, device, hps)


if __name__ == "__main__":
    fire(run)
