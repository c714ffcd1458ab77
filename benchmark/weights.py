"""Weights drawn from the seed, on the device, in a few large calls.

The layout (names and shapes) comes from the reference, so the same draw
feeds the program and the reference. Scales follow the program's
initialisers for the tables (0.02 * init_scale for the token table, 0.01
* init_scale for the position and label tables) and upstream's fan-in
bound for convolutions, with departures written in each configuration's
`assumed`: the transformer's products are drawn at unit gain, std
1 / sqrt(fan in), as trained weights are, where upstream's 0.02 *
init_scale makes a random 72-layer stack attend uniformly and give every
position the same best token (the greedy comparison then sees nothing);
biases and LayerNorm parameters are drawn too (upstream starts them at 0
and 1), so that the comparison sees where each is added.
"""

import math

import torch

CHUNK = 1 << 28  # numbers per generator call


def scale(name, shape, init_scale):
    """(mean, std) of the parameter `name`."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 1:
        return (1.0, 0.05) if leaf == "g" else (0.0, 0.01)
    if len(shape) == 3:  # (out, in, k) or a transposed conv's (in, out, k)
        return 0.0, 1.0 / math.sqrt(3 * shape[1] * shape[2])
    if "pos_emb" in name or name.startswith("y_emb."):
        return 0.0, 0.01 * init_scale
    if ".transformer." in name:
        return 0.0, 1.0 / math.sqrt(shape[0])
    return 0.0, 0.02 * init_scale


def draw(layout, seed, device, init_scale, dtype=torch.float32):
    """{name: tensor} for every (name, shape) of `layout`, from one
    torch.Generator on `device` seeded `seed`: consecutive parameters share
    one normal draw of up to CHUNK numbers."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out, group, n = {}, [], 0

    def flush():
        nonlocal group, n
        if not group:
            return
        buf = torch.randn(n, generator=gen, device=device, dtype=dtype)
        off = 0
        for name, shape in group:
            k = math.prod(shape)
            mean, std = scale(name, shape, init_scale)
            t = buf[off:off + k].view(shape)
            t.mul_(std).add_(mean)
            out[name] = t
            off += k
        group, n = [], 0

    for name, shape in layout:
        k = math.prod(shape)
        if n and n + k > CHUNK:
            flush()
        group.append((name, tuple(shape)))
        n += k
    flush()
    return out
