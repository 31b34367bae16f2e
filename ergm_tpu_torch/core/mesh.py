"""Device meshes over the world's ranks, the Megatron partition rules and
ZeRO-1 (counterpart of ``ergm_tpu/core/mesh.py``).

JAX lays a ``Mesh`` over devices and lets GSPMD insert the collectives.
Here one process drives one device: a ``Mesh`` lays the world's ranks
out row-major over named axes (``data`` for batch sharding, ``model``
for tensor parallelism), gives this rank its coordinates and a process
group along each axis, and the training path issues the collectives
itself (``models/gpt2.py``'s Megatron pair, ``train/steps.py``'s
gradient reduction and ZeRO-1 gather).

The partition rules are JAX's (``param_partition_spec``,
``zero1_dim``), pure Python over names and shapes, on the port's
parameter names (``blocks.{i}.attn.c_attn.kernel``: layers are a
``ModuleList``, so no spec has JAX's leading layer axis). One thing
differs on purpose: JAX splits the fused ``c_attn`` [D, 3D] by columns
and GSPMD reshards around the head split; a contiguous column split
here would give rank 0 all of q and part of k. So q, k and v are each
split by head groups (``head_groups``: contiguous, as even as the
count allows, the first ranks one head more: gpt2-xl's 25 heads over 8
ranks go 4/3/3/3/3/3/3/3), and the MLP's inner dim likewise by
contiguous columns.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
ALL = "*"  # the group of every rank of a mesh


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per dim, an axis name, a tuple
    of names or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """The world's ranks laid out row-major over named axes.

    ``shape``: {axis: size} in axis order. ``coords``: this rank's index
    on each axis. ``group(axis)``: the process group of the ranks that
    share this rank's other coordinates (None outside a world);
    ``group(ALL)``: every rank of the mesh."""

    def __init__(self, shape: Dict[str, int], rank: int, groups: Dict[str, object]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.ranks = np.arange(int(np.prod(list(shape.values())))).reshape(
            tuple(shape.values()))
        where = np.argwhere(self.ranks == rank)
        self.coords = ({a: int(i) for a, i in zip(self.axis_names, where[0])} if len(where)
                       else None)
        self.groups = groups

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        return 0 if self.coords is None else int(self.coords.get(axis, 0))

    def group(self, axis: str):
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"


def make_mesh(shape: Sequence[int] = (-1,), axis_names: Sequence[str] = (DATA_AXIS,),
              world_size: Optional[int] = None, rank: Optional[int] = None) -> Mesh:
    """A mesh over the world's ranks (``torch.distributed``'s world, or
    ``world_size`` ranks laid out without process groups when no world
    is initialized). One ``-1`` absorbs the rest of the world, so the
    default ``(-1,)`` is data parallelism over every rank; an explicit
    smaller shape uses a prefix of the ranks, as JAX uses a prefix of the
    devices. Inside a world every rank must call this, in the same order
    (the axis groups are made with ``dist.new_group``)."""
    in_world = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if in_world else 1
    if rank is None:
        rank = dist.get_rank() if in_world else 0
    shape = [int(s) for s in shape]
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {tuple(axis_names)} differ in "
                         f"length")
    if shape.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    known = int(np.prod([s for s in shape if s != -1])) if shape else 1
    if -1 in shape:
        if world_size % known:
            raise ValueError(f"{world_size} devices not divisible by {known}")
        shape[shape.index(-1)] = world_size // known
    total = int(np.prod(shape))
    if total > world_size:
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {world_size}")
    names = tuple(axis_names)
    groups: Dict[str, object] = {}
    if in_world:
        ranks = np.arange(total).reshape(shape)
        for ax, name in enumerate(names):
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
            for line in lines:  # every rank makes every group, in one order
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
        g = dist.new_group(list(range(total)))
        if rank < total:
            groups[ALL] = g
    return Mesh(dict(zip(names, shape)), rank, groups)


def batch_rows(batch_size: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """This rank's rows of a global batch, ``batch_sharding``'s placement:
    data rank r takes ``[r B / dp, (r + 1) B / dp)``."""
    if mesh is None:
        return 0, batch_size
    dp, r = mesh.axis_size(DATA_AXIS), mesh.index(DATA_AXIS)
    if batch_size % dp:
        raise ValueError(f"batch_size={batch_size} must be divisible by the mesh data axis "
                         f"({dp} devices); pick a divisible batch size or a smaller mesh_shape")
    n = batch_size // dp
    return r * n, (r + 1) * n


def fill_rows(batch_size: int, mesh: Optional[Mesh]) -> int:
    """The batch padded to a multiple of the data axis (JAX's
    ``_mesh_batch_placement``): the rows the ranks take between them."""
    dp = 1 if mesh is None else mesh.axis_size(DATA_AXIS)
    return -(-batch_size // dp) * dp


def pad_rows(x, rows: int):
    """A host array's leading (batch) axis filled up to ``rows`` by
    repeating its last row (None stays None); callers drop the fill rows
    by the original batch size."""
    if x is None:
        return None
    x = np.asarray(x)
    if x.shape[0] >= rows:
        return x
    return np.concatenate([x, np.repeat(x[-1:], rows - x.shape[0], axis=0)], axis=0)


def local_heads(n_head: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """This model rank's head range [h0, h1) of ``n_head`` (``head_groups``;
    all heads without a model axis)."""
    if mesh is None:
        return 0, n_head
    return head_groups(n_head, mesh.axis_size(MODEL_AXIS))[mesh.index(MODEL_AXIS)]


def logical_to_sharding(mesh: Mesh, spec: PartitionSpec) -> PartitionSpec:
    """``spec`` with the axis names the mesh lacks dropped (e.g. "model"
    on a pure data-parallel mesh)."""
    cleaned = []
    for entry in spec:
        if entry is None:
            cleaned.append(None)
        elif isinstance(entry, str):
            cleaned.append(entry if entry in mesh.axis_names else None)
        else:
            kept = tuple(a for a in entry if a in mesh.axis_names)
            cleaned.append(kept if kept else None)
    return P(*cleaned)


_COLUMN = ("c_attn.kernel", "q_attn.kernel", "c_fc.kernel", "c_attn.kernel_q",
           "q_attn.kernel_q", "c_fc.kernel_q", "c_attn.kernel_scale", "q_attn.kernel_scale",
           "c_fc.kernel_scale")
_ROW = ("c_proj.kernel", "c_proj.kernel_q")
_COLUMN_BIAS = ("c_attn.bias", "q_attn.bias", "c_fc.bias")


def param_partition_spec(name: str) -> PartitionSpec:
    """JAX's Megatron spec of a parameter, by its name in the port
    (``ergm_tpu/core/mesh.py:99-113``): column-parallel kernels (qkv, the
    cross q and kv, the MLP's up projection; int8 ``kernel_q`` and their
    per-out ``kernel_scale`` too) shard their output features, row-parallel
    ``c_proj`` kernels their input features, column-parallel biases follow
    their sharded dim; the rest (LayerNorms, embeddings, the emotion head,
    row-parallel biases and scales) is replicated, ``P()``."""
    if name.endswith(_COLUMN):
        return P(None, MODEL_AXIS)
    if name.endswith(_ROW):
        return P(MODEL_AXIS, None)
    if name.endswith(_COLUMN_BIAS):
        return P(MODEL_AXIS)
    if name.endswith("wte.embedding"):
        return P(None, None)
    return P()


def head_groups(n: int, parts: int) -> List[Tuple[int, int]]:
    """``n`` heads (or columns) over ``parts`` ranks: contiguous
    [lo, hi) ranges, the first ``n % parts`` one longer."""
    base, extra = divmod(n, parts)
    out, lo = [], 0
    for r in range(parts):
        hi = lo + base + (r < extra)
        out.append((lo, hi))
        lo = hi
    return out


def tp_layout(name: str, shape: Sequence[int], config, parts: int
              ) -> Optional[Tuple[int, List[torch.Tensor]]]:
    """Where the model axis splits a parameter of full ``shape``: (dim,
    the indices along it that each model rank holds), or None when it is
    replicated. Attention projections split by head groups (q, k and v
    each), the MLP by contiguous inner columns."""
    spec = param_partition_spec(name)
    if MODEL_AXIS not in spec or parts <= 1:
        return None
    dim = spec.index(MODEL_AXIS)
    if ".mlp." in name:
        return dim, [torch.arange(lo, hi) for lo, hi in head_groups(shape[dim], parts)]
    dh = config.head_dim
    width = config.n_head * dh
    fused = shape[dim] // width  # 3 for c_attn, 2 for the cross c_attn, 1 for q and c_proj
    idx = []
    for lo, hi in head_groups(config.n_head, parts):
        cols = torch.arange(lo * dh, hi * dh)
        idx.append(torch.cat([j * width + cols for j in range(fused)]))
    return dim, idx


def _named_tensors(params) -> Dict[str, torch.Tensor]:
    """Parameters and the int8 buffers, by name."""
    out = dict(params.named_parameters())
    out.update({k: v for k, v in params.named_buffers() if v is not None})
    return out


@torch.no_grad()
def shard_params(params, mesh: Mesh):
    """This rank's shard of the parameters, IN PLACE (returns ``params``):
    every tensor the model axis splits is replaced by the rows or columns
    this model rank holds; the rest stays whole (replicated)."""
    parts = mesh.axis_size(MODEL_AXIS)
    if parts <= 1:
        return params
    me = mesh.index(MODEL_AXIS)
    for name, t in _named_tensors(params).items():
        lay = tp_layout(name, t.shape, params.config, parts)
        if lay is None:
            continue
        dim, idx = lay
        local = t.index_select(dim, idx[me].to(t.device)).contiguous()
        mod_name, leaf = name.rsplit(".", 1)
        mod = params.get_submodule(mod_name)
        if isinstance(t, torch.nn.Parameter):
            setattr(mod, leaf, torch.nn.Parameter(local, requires_grad=t.requires_grad))
        else:
            setattr(mod, leaf, local)
    return params


def tp_full_shape(name: str, local: torch.Tensor, config, parts: int) -> Optional[tuple]:
    """The full shape of a model-split tensor from its name and config,
    or None when the model axis does not split it."""
    spec = param_partition_spec(name)
    if MODEL_AXIS not in spec or parts <= 1:
        return None
    dim = spec.index(MODEL_AXIS)
    shape = list(local.shape)
    if ".mlp." in name:
        shape[dim] = config.inner_dim  # c_fc's columns and c_proj's rows
    else:
        width = config.n_head * config.head_dim
        fused = 3 if ".attn.c_attn." in name else 2 if ".cross_attn.c_attn." in name else 1
        shape[dim] = fused * width
    return tuple(shape)


def gather_model(name: str, local: torch.Tensor, config, mesh: Mesh) -> torch.Tensor:
    """The whole of a model-split tensor from every model rank's part (a
    collective over the model group; replicated tensors come back as they
    are). Parts of uneven head groups travel padded to the longest."""
    parts = mesh.axis_size(MODEL_AXIS)
    full_shape = tp_full_shape(name, local, config, parts)
    if full_shape is None:
        return local
    dim, idx = tp_layout(name, full_shape, config, parts)
    longest = max(len(i) for i in idx)
    pad = list(local.shape)
    pad[dim] = longest
    buf = torch.zeros(pad, dtype=local.dtype, device=local.device)
    buf.narrow(dim, 0, local.shape[dim]).copy_(local)
    got = [torch.empty_like(buf) for _ in range(parts)]
    dist.all_gather(got, buf, group=mesh.group(MODEL_AXIS))
    full = torch.empty(full_shape, dtype=local.dtype, device=local.device)
    for r in range(parts):
        full.index_copy_(dim, idx[r].to(local.device), got[r].narrow(dim, 0, len(idx[r])))
    return full


def split_model(name: str, full: torch.Tensor, config, mesh: Mesh) -> torch.Tensor:
    """This model rank's part of a whole tensor (``shard_params``'s rule)."""
    lay = tp_layout(name, full.shape, config, mesh.axis_size(MODEL_AXIS))
    if lay is None:
        return full
    dim, idx = lay
    return full.index_select(dim, idx[mesh.index(MODEL_AXIS)].to(full.device)).contiguous()


def zero1_dim(shape: Sequence[int], dp: int, taken: Optional[int] = None) -> Optional[int]:
    """JAX's ZeRO-1 rule for one moment (``ergm_tpu/core/mesh.py:132-157``):
    the largest dim divisible by the data size (ties to the first), other
    than ``taken`` (the dim the model axis already splits); None (stay
    replicated) for scalars, ``dp`` of 1 and moments with no such dim."""
    if dp <= 1 or len(shape) == 0:
        return None
    best = None
    for i, d in enumerate(shape):
        if i != taken and d % dp == 0 and d >= dp and (best is None or d > shape[best]):
            best = i
    return best


def zero1_sharding_tree(params, mesh: Mesh) -> List[Optional[int]]:
    """The ZeRO-1 dim of each parameter's moments, in ``parameters()``
    order, from the shapes this rank holds (the dim the model axis
    splits is never taken again)."""
    dp = mesh.axis_size(DATA_AXIS)
    parts = mesh.axis_size(MODEL_AXIS)
    out = []
    for name, p in params.named_parameters():
        spec = param_partition_spec(name)
        taken = spec.index(MODEL_AXIS) if (MODEL_AXIS in spec and parts > 1) else None
        out.append(zero1_dim(tuple(p.shape), dp, taken))
    return out


class Zero1:
    """ZeRO stage 1 over the data axis: each data rank keeps and updates
    the slice ``[r c, (r + 1) c)`` of every moment along its ``zero1_dim``
    (c = that dim / dp); moments without one stay whole on every rank.
    Gradients are reduced to every rank before the update; after it each
    rank's updated slice of the parameters is all-gathered."""

    def __init__(self, dims: List[Optional[int]], mesh: Mesh):
        self.dims = dims
        self.dp = mesh.axis_size(DATA_AXIS)
        self.me = mesh.index(DATA_AXIS)
        self.group = mesh.group(DATA_AXIS)

    def _slice(self, t: torch.Tensor, d: Optional[int]) -> torch.Tensor:
        if d is None:
            return t
        c = t.shape[d] // self.dp
        return t.narrow(d, self.me * c, c)

    def local(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Views of this rank's slices (whole tensors where not sharded)."""
        return [self._slice(t, d) for t, d in zip(tensors, self.dims)]

    def local_of(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of the whole moment ``t`` of parameter ``i``."""
        return self._slice(t, self.dims[i])

    @torch.no_grad()
    def gather(self, tensors: List[torch.Tensor]) -> None:
        """Fills every sharded tensor IN PLACE from all data ranks' slices."""
        for t, d in zip(tensors, self.dims):
            if d is not None:
                t.copy_(self.whole(self._slice(t, d).contiguous(), d))

    def whole(self, part: torch.Tensor, d: Optional[int]) -> torch.Tensor:
        """The whole tensor from each data rank's slice ``part`` along ``d``."""
        if d is None:
            return part
        got = [torch.empty_like(part) for _ in range(self.dp)]
        dist.all_gather(got, part.contiguous(), group=self.group)
        return torch.cat(got, dim=d)


@torch.no_grad()
def shard_opt_state(opt_state, mesh: Mesh, dims: Optional[List[Optional[int]]] = None):
    """ZeRO-1 placement of an optimizer state IN PLACE (returns it): each
    moment (``mu`` and ``nu`` of ``train.steps.AdamWState``, a bf16 ``mu``
    too) keeps this data rank's slice along its ``zero1_dim``. ``dims``
    default to ``[zero1_dim(shape of mu_i)]`` (which the caller gets from
    ``zero1_sharding_tree`` when a model axis splits the parameters)."""
    if opt_state.zero is not None:  # idempotent: already ZeRO-1
        return opt_state
    dp = mesh.axis_size(DATA_AXIS)
    if dims is None:
        dims = [zero1_dim(tuple(m.shape), dp) for m in opt_state.mu]
    zero = Zero1(list(dims), mesh)
    opt_state.mu = [m.clone() for m in zero.local(opt_state.mu)]
    opt_state.nu = [m.clone() for m in zero.local(opt_state.nu)]
    opt_state.zero = zero
    return opt_state
