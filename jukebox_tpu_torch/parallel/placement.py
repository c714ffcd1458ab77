"""Where a model's parameters live on the ("dp", "mp") mesh, and the
collectives of a train step around them (the placements that the JAX
package's GSPMD derives from its specs, written out over
torch.distributed).

Megatron split over "mp" (tensor_parallel), as prior_param_specs places
each parameter: every transformer's c_attn, c_enc_kv and c_fc keep the
rank's columns and every c_proj its rows, on the module itself. q, k and
v (k and v of c_enc_kv) are each split by columns, and a row-split product
is all-reduced before its bias is added (models/attention.py,
models/transformer.py). Where mp divides n_head, a rank's columns are
n_head / mp whole heads: its attention, flash kernels included, runs on
its heads alone and its ring caches hold n_state / mp columns. Where it
does not (the 1-head upsamplers and small_prior, the 2-head 1b top at
mp=4), the ranks gather q, k and v whole, every rank runs the whole
attention with the same kernels and holds whole caches, and each takes its
columns of the output into its rows of c_proj (parallel/dist.py's gather /
scatter pair: the gather's backward is the rank's slice, the slice's an
all-gather).

ZeRO-3 over "dp" (fully_shard_model, torch's fully_shard): each parameter
of fsdp_param_specs' "dp" axis is held as the rank's chunk of that axis
(contiguous; what Adam updates, with m and v the same shape, and what the
EMA follows). Each ResAttnBlock is a unit that all-gathers its parameters
for its forward and again for its backward (the recomputing backward of
checkpointed blocks too), and frees them after; the root unit does the
same for the parameters outside the blocks (embeddings, conditioners, the
output table). Gradients are reduce-scattered unit by unit.

Data parallel: gradients of whole parameters are averaged over "dp" by
all-reduce, of ZeRO chunks by the reduce-scatter, before the reference's
clipped Adam; the gradient norm sums each distinct piece once over the
world.
"""

import contextlib

import torch
from torch.distributed.tensor import DTensor

from jukebox_tpu_torch.parallel import dist as pdist
from jukebox_tpu_torch.parallel.dist import mp_slice, mp_unslice
from jukebox_tpu_torch.parallel.shardings import (fsdp_param_specs,
                                                  prior_param_specs)

# bucket of the gradient all-reduce, elements
BUCKET = 1 << 25


def _own(t):
    """t as a tensor with a storage of its own."""
    return t.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# the Megatron split
# ---------------------------------------------------------------------------

def _parts(model, name):
    """The equal parts of a split product's columns, each split on its own:
    c_attn's q | k | v (q alone in f6 layers), c_enc_kv's k | v, one
    else."""
    owner, dense = name.rsplit(".", 2)[:2]
    if dense == "c_attn":
        return 1 if model.get_submodule(owner).attn_func == 6 else 3
    return 2 if dense == "c_enc_kv" else 1


def tensor_parallel(model, mesh):
    """Split `model` over mesh's "mp" in place, each parameter as
    prior_param_specs places it (the module docstring), and return {parameter
    name: (axis, parts)} of the split parameters. Raises where mp does not
    divide a split product's columns."""
    from jukebox_tpu_torch.models.attention import FactoredAttention
    from jukebox_tpu_torch.models.transformer import MLP, Transformer
    mp, r, group = mesh.mp, mesh.mp_rank, mesh.mp_group
    for name, m in model.named_modules():
        if isinstance(m, FactoredAttention) and m.n_state % mp:
            raise ValueError(
                f"{name}: {m.n_state} columns of q, k and v do not split "
                f"over mp={mp}")
    split = {}
    params = dict(model.named_parameters())
    for name, spec in prior_param_specs(model).items():
        if "mp" not in spec:
            continue
        axis, parts = spec.index("mp"), _parts(model, name)
        p = params[name]
        p.data = _own(mp_slice(p.data, axis, parts, mp, r))
        split[name] = (axis, parts)
    for m in model.modules():
        if isinstance(m, FactoredAttention) and m.n_head % mp:
            m.whole = True
        elif isinstance(m, FactoredAttention):
            m.heads = (r * (m.n_head // mp), m.n_head)
            m.n_head //= mp
            m.n_state //= mp
        if isinstance(m, (FactoredAttention, MLP, Transformer)):
            m.tp = group
    return split


# ---------------------------------------------------------------------------
# ZeRO-3 over "dp"
# ---------------------------------------------------------------------------

def fully_shard_model(model, mesh, axes):
    """ZeRO-3 of `model` by torch's fully_shard over mesh's "dp": each
    ResAttnBlock a unit, the root the rest, each parameter of a "dp" axis
    in axes sharded on that axis (its local shard a contiguous chunk); the
    others ignored, whole, left to the data-parallel all-reduce. The root
    too frees its parameters after the forward, so that a forward always
    gathers what Adam or the EMA wrote into the shards since. Gradients
    are reduce-scattered as sums (the divide factor 1: Placement.grads
    averages). z_forward, the prior's training and evaluation forward,
    gathers as forward does."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard
    from jukebox_tpu_torch.models.transformer import ResAttnBlock
    name_of = {p: n for n, p in model.named_parameters()}
    kw = dict(mesh=mesh.device_mesh["dp"], reshard_after_forward=True,
              shard_placement_fn=lambda p: Shard(axes[name_of[p]]),
              ignored_params={p for p, n in name_of.items()
                              if axes[n] is None})
    units = [m for m in model.modules() if isinstance(m, ResAttnBlock)]
    for m in units:
        fully_shard(m, **kw)
    fully_shard(model, **kw)
    for m in units + [model]:
        m.set_gradient_divide_factor(1.0)
        m.set_force_sum_reduction_for_comms(True)  # gloo has no PREMUL_SUM
    if hasattr(model, "z_forward"):
        register_fsdp_forward_method(model, "z_forward")
    return units + [model]


# ---------------------------------------------------------------------------
# the placement of one model
# ---------------------------------------------------------------------------

class Placement:
    """A model on the mesh: Megatron split over "mp" when mesh.mp > 1 (a
    prior), ZeRO-3 over "dp" with fsdp, data parallel over "dp" always.
    Build it on the full model after any restore; it changes the model in
    place. specs: the fsdp_param_specs / prior_param_specs of the full
    model, in its parameter names; split: the Megatron split's {name:
    (axis, parts)}; dp_axes: {name: the ZeRO-3 axis or None}; units: the
    fully_shard modules (None without fsdp, and in a world of one without
    a process group, where dp=1 shards nothing)."""

    def __init__(self, model, mesh, fsdp=False, min_size=1 << 14):
        self.model, self.mesh = model, mesh
        tp = mesh.mp > 1
        base = prior_param_specs(model) if tp else None
        self.specs = (fsdp_param_specs(model, mesh.dp, base, min_size)
                      if fsdp else base or {n: (None,) * p.ndim for n, p
                                            in model.named_parameters()})
        self.split = tensor_parallel(model, mesh) if tp else {}
        self.dp_axes = {n: (s.index("dp") if "dp" in s else None)
                        for n, s in self.specs.items()}
        self.units = (fully_shard_model(model, mesh, self.dp_axes)
                      if fsdp and mesh.device_mesh is not None else None)
        # each leaf's share of the world that holds the same piece
        self.weight = {}
        for n in self.specs:
            copies = mesh.world
            if self.dp_axes[n] is not None:
                copies //= mesh.dp
            if n in self.split:
                copies //= mesh.mp
            self.weight[n] = 1.0 / copies

    @property
    def params(self):
        """{name: the tensor Adam updates}: the module's (mp-split)
        parameters, each sharded one's local chunk under ZeRO-3."""
        return {n: (p.detach().to_local() if isinstance(p, DTensor) else p)
                for n, p in self.model.named_parameters()}

    # -- one tensor's pieces --------------------------------------------------

    @torch.no_grad()
    def shard(self, name, full):
        """The rank's piece of a whole tensor shaped like parameter
        `name` (its moments, an EMA shadow)."""
        t = full.detach()
        if name in self.split:
            axis, parts = self.split[name]
            t = mp_slice(t, axis, parts, self.mesh.mp, self.mesh.mp_rank)
        ax = self.dp_axes[name]
        if ax is not None:
            t = t.chunk(self.mesh.dp, ax)[self.mesh.dp_rank]
        return _own(t)

    @torch.no_grad()
    def full(self, name, local):
        """The whole tensor of parameter `name` from every rank's piece
        (a collective: every rank calls it)."""
        t = local.detach()
        ax = self.dp_axes[name]
        if ax is not None:
            shape = list(t.shape)
            shape[ax] *= self.mesh.dp
            t = pdist.gather_chunks(torch.empty(shape, dtype=t.dtype,
                                                device=t.device),
                                    t, self.mesh.dp_group, ax)
        if name in self.split:
            axis, parts = self.split[name]
            pieces = pdist.all_gather_cat(t[None], self.mesh.mp_group, 0)
            t = mp_unslice(list(pieces.unbind(0)), axis, parts)
        return t

    def full_dict(self, named):
        return {n: self.full(n, t) for n, t in named.items()}

    def shard_dict(self, named):
        return {n: self.shard(n, t) for n, t in named.items()}

    # -- a train step ---------------------------------------------------------

    def begin_step(self):
        for p in self.model.parameters():
            p.grad = None

    def grads(self):
        """After the backward: {name: the rank's gradient piece} averaged
        over "dp" (None where a parameter got no gradient): the sharded
        ones' local chunks of the reduce-scattered sum, the whole ones
        all-reduced."""
        out = {}
        whole = []
        for n, p in self.model.named_parameters():
            g = p.grad
            if isinstance(g, DTensor):
                g = g.to_local()
            elif g is not None:
                whole.append(g)
            out[n] = g
            p.grad = None
        self._all_reduce(whole)
        if self.mesh.dp > 1:
            inv = 1.0 / self.mesh.dp
            out = {n: (None if g is None else g * inv)
                   for n, g in out.items()}
        return out

    def _all_reduce(self, tensors):
        """Sum each tensor over "dp" in place, in flat buckets of one dtype
        and at most BUCKET elements."""
        group = self.mesh.dp_group
        if pdist.group_size(group) == 1:
            return
        buckets = []
        for t in tensors:
            last = buckets[-1] if buckets else None
            if (last and last[0].dtype == t.dtype
                    and sum(b.numel() for b in last) + t.numel() <= BUCKET):
                last.append(t)
            else:
                buckets.append([t])
        for bucket in buckets:
            flat = pdist.all_reduce_(torch.cat([b.reshape(-1)
                                                for b in bucket]), group)
            for b, part in zip(bucket, flat.split([b.numel()
                                                   for b in bucket])):
                b.copy_(part.view_as(b))

    def mean_over_dp(self, t):
        """A scalar (loss, metric) averaged over "dp"."""
        if self.mesh.dp == 1:
            return t
        t = pdist.all_reduce_(t.detach().float().clone(),
                              self.mesh.dp_group)
        return t / self.mesh.dp

    @contextlib.contextmanager
    def materialized(self):
        """Every parameter gathered (sampling through the layer modules,
        whose decode steps run outside the units' forward)."""
        if self.units is None:
            yield
            return
        for m in self.units:
            m.unshard()
        try:
            yield
        finally:
            for m in self.units:
                m.reshard()
