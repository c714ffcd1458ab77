"""Process group, device mesh and collectives of the PyTorch port
(counterpart of jukebox_tpu/parallel/dist.py).

One process per rank. setup_dist() reads the JAX package's three variables,

    JAX_COORDINATOR_ADDRESS  host:port of rank 0's rendezvous
    JAX_NUM_PROCESSES        the world size
    JAX_PROCESS_ID           this process's rank

into torch.distributed.init_process_group; without an address it is a
no-op and the process runs alone. The backend is NCCL for CUDA tensors and
gloo for the CPU; several ranks on one card need gloo (NCCL refuses two
ranks on one device) and ask for it with JUKEBOX_DIST_BACKEND=gloo:
nothing switches backend by itself.

make_mesh lays the ranks out row-major on a ("dp", "mp") grid, as
jax.devices() orders them under the JAX package's reshape: rank =
dp_index * mp + mp_index, so the ranks of one model-parallel group are
neighbours and each data-parallel index owns one slice of the global
batch. Replication is a broadcast from rank 0. The collectives below skip
groups of one rank, so a world of one runs the same code without a
process group.
"""

import os

import torch
import torch.distributed as dist

BACKEND_ENV = "JUKEBOX_DIST_BACKEND"


def setup_dist(device="cuda"):
    """(rank, world): the process group of the JAX_* variables, created
    once; (0, 1) without JAX_COORDINATOR_ADDRESS. The backend is
    JUKEBOX_DIST_BACKEND ("nccl" or "gloo") where it is set, else NCCL on
    the card and gloo on the CPU. On the card each rank takes device
    rank % device_count."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return 0, 1
    world = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("JAX_PROCESS_ID", "0"))
    cuda = torch.device(device).type == "cuda"
    backend = os.environ.get(BACKEND_ENV) or ("nccl" if cuda else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl":
        if not cuda:
            raise ValueError("NCCL carries CUDA tensors only: train on the "
                             "CPU with backend gloo")
        n_dev = torch.cuda.device_count()
        if world > n_dev:
            raise ValueError(f"NCCL takes one rank a device: {world} ranks "
                             f"on {n_dev} devices need "
                             f"{BACKEND_ENV}=gloo")
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=world, rank=rank)
    return rank, world


def rank_device(device="cuda"):
    """This rank's device: the card setup_dist set, or the CPU."""
    if torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank():
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """The ranks on a (dp, mp) grid: this rank's coordinates dp_rank and
    mp_rank and its groups dp_group (the ranks of its mp index) and
    mp_group (the ranks of its dp index), from a torch DeviceMesh with
    dims ("dp", "mp") when a process group exists (None otherwise: a world
    of one)."""

    def __init__(self, dp, mp, device_mesh=None):
        self.dp, self.mp = dp, mp
        self.device_mesh = device_mesh
        self.rank = get_rank()
        self.dp_rank, self.mp_rank = divmod(self.rank, mp)
        if device_mesh is not None:
            self.dp_group = device_mesh.get_group("dp")
            self.mp_group = device_mesh.get_group("mp")
            self.world_group = dist.group.WORLD
        else:
            self.dp_group = self.mp_group = self.world_group = None

    @property
    def world(self):
        return self.dp * self.mp


def make_mesh(mesh_dp=-1, mesh_mp=1, device="cuda"):
    """The ("dp", "mp") mesh over every rank (dist.py:52-65 of the JAX
    package): mesh_dp=-1 takes all ranks that mesh_mp leaves; dp * mp must
    be the world size."""
    n = world_size()
    if mesh_dp == -1:
        assert n % mesh_mp == 0, f"{n} ranks do not split into mp={mesh_mp}"
        mesh_dp = n // mesh_mp
    assert mesh_dp * mesh_mp == n, f"{mesh_dp}x{mesh_mp} != {n} ranks"
    device_mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        device_mesh = init_device_mesh(torch.device(device).type,
                                       (mesh_dp, mesh_mp),
                                       mesh_dim_names=("dp", "mp"))
    return Mesh(mesh_dp, mesh_mp, device_mesh)


def batch_slice(global_bs, mesh):
    """This rank's rows of a global batch [global_bs, ...] as a slice:
    its dp index's contiguous block (every rank of one mp group reads the
    same rows)."""
    per, rem = divmod(global_bs, mesh.dp)
    assert rem == 0, f"global batch {global_bs} over dp={mesh.dp}"
    return slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)


def dp_rows(n, mesh):
    """The global batch rows of this rank's n rows as the training loader
    deals them (data/data_processor.py ShardedLoader: each "dp" index reads
    every dp-th item of the epoch's order): dp_rank, dp_rank + dp, ...,
    the rows a step's dropout masks and aug_blend mix are drawn for."""
    return [mesh.dp_rank + mesh.dp * k for k in range(n)]


# ---------------------------------------------------------------------------
# collectives (no-ops over a group of one rank)
# ---------------------------------------------------------------------------

def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_(t, group, op="sum"):
    """t summed (op "sum"), or its maximum ("max"), over the group, in
    place. Returns t."""
    if group_size(group) > 1:
        dist.all_reduce(t, {"sum": dist.ReduceOp.SUM,
                            "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def all_gather_cat(t, group, dim=0):
    """The group's tensors concatenated along dim in rank order (each rank
    gives one of the same shape)."""
    n = group_size(group)
    if n == 1:
        return t
    return torch.cat(_all_gather_single(t, group, n).unbind(0), dim=dim)


def _all_gather_single(t, group, n):
    """[n, *t.shape]: the group's tensors stacked in rank order."""
    t = t.contiguous().reshape((1,) + tuple(t.shape))
    out = torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, t, group=group)
    return out


def gather_chunks(out, local, group, axis):
    """out (full shape) = the group's local chunks [.., n * c, ..]
    concatenated along axis in rank order."""
    n = group_size(group)
    if n == 1:
        out.copy_(local)
        return out
    buf = _all_gather_single(local, group, n)
    out.copy_(buf.movedim(0, axis).reshape(out.shape))
    return out


def broadcast_(t, src=0, group=None):
    """t from global rank src on every rank of group (default: the
    world), in place."""
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.broadcast(t, src, group=group)
    return t


def replicate(tensors, src=0):
    """Every tensor of an iterable broadcast from rank src: the
    replicated placement. Returns the tensors."""
    tensors = list(tensors)
    for t in tensors:
        broadcast_(t, src)
    return tensors


def mp_slice(t, axis, parts, mp, r):
    """Rank r's piece of t along axis: of each of `parts` equal parts
    (q | k | v), its r-th of mp chunks."""
    per = t.shape[axis] // parts
    loc = per // mp
    return torch.cat([t.narrow(axis, p * per + r * loc, loc)
                      for p in range(parts)], dim=axis)


def mp_unslice(pieces, axis, parts):
    """The whole tensor from every rank's mp_slice piece, in rank
    order."""
    mp = len(pieces)
    loc = pieces[0].shape[axis] // parts
    return torch.cat([pieces[r].narrow(axis, p * loc, loc)
                      for p in range(parts) for r in range(mp)], dim=axis)


def rank_cols(x, group, parts=1):
    """This rank's mp_slice of the last axis of x over the group."""
    n = group_size(group)
    if n == 1:
        return x
    return mp_slice(x, x.dim() - 1, parts, n, dist.get_rank(group))


def gather_cols(x, group, parts=1):
    """The whole last axis from every rank's rank_cols piece x."""
    n = group_size(group)
    if n == 1:
        return x
    return mp_unslice(list(_all_gather_single(x, group, n).unbind(0)),
                      x.dim() - 1, parts)


# ---------------------------------------------------------------------------
# the Megatron pairs: identity one way, all-reduce the other; all-gather
# one way, the rank's slice the other
# ---------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    """Forward: x. Backward: the gradient summed over the group (the input
    of a column-split product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Forward: x summed over the group (the output of a row-split
    product). Backward: the gradient as it is."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x, group):
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


class _GatherFromGroup(torch.autograd.Function):
    """Forward: the rank's columns (rank_cols) gathered whole over the
    group. Backward: the rank's columns of the gradient (every rank holds
    the whole gradient, computed alike)."""

    @staticmethod
    def forward(ctx, x, group, parts):
        ctx.group, ctx.parts = group, parts
        return gather_cols(x.contiguous(), group, parts)

    @staticmethod
    def backward(ctx, g):
        return rank_cols(g, ctx.group, ctx.parts).contiguous(), None, None


class _ScatterToGroup(torch.autograd.Function):
    """Forward: the rank's columns of x (the input of a row-split product
    after work done whole on every rank). Backward: the group's gradient
    pieces gathered whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return rank_cols(x, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_cols(g.contiguous(), ctx.group), None


def gather_from_group(x, group, parts=1):
    if group_size(group) == 1:
        return x
    return _GatherFromGroup.apply(x, group, parts)


def scatter_to_group(x, group):
    return x if group_size(group) == 1 else _ScatterToGroup.apply(x, group)
