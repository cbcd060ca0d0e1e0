"""The rank grid and the placement of parameters and batches (port of the
data/expert half of competesmoe_tpu/parallel/mesh.py, `:1-123`; its
tensor-parallel half waits for ROADMAP item 1.7b).

JAX's mesh has axes ('data', 'expert') over the devices of every host,
and `jit` partitions one global program over it. Here each rank is a
process with its own rows of the batch, and `Mesh` is the same grid of
ranks: rank r sits at data r // n_expert and expert r % n_expert (JAX's
`devices.reshape(n // n_expert, n_expert)`). It holds this rank's
coordinates and, per axis, the process group of the ranks that share its
other coordinate (`Axis`); every rank creates every group, in one order.

A parameter's placement follows JAX's `param_spec` exactly, read on the
parameter's JAX layout (an nn.Linear weight is flax's kernel transposed;
`_jax_layout`): an expert bank (`EXPERT_PARAM_NAMES`) is sharded on its
dim 0 over 'expert'; with FSDP, a parameter of at least `fsdp_min_size`
elements is sharded over 'data' on its largest dim that divides by the
data size; everything else is replicated. `shard_params` applies it:

- an expert bank that the expert-parallel dispatch reads
  (`parallel/expert_parallel.py`) becomes this rank's shard: tokens
  travel, the bank does not;
- any other sharded parameter keeps only this rank's shard (in a
  `_sharded` submodule of its module) and is all-gathered each time the
  module reads the attribute, whose backward reduce-scatters the gradient
  (`gather_on_use`): FSDP's mechanism, and JAX's expert-sharded weights
  read by replicated-token compute (`-moe.impl fused|grouped|dense` with
  an expert axis). A recompute (remat, the competition step's
  checkpoint) gathers again.

After the backward, `reduce_gradients` sums each gradient over the mesh
axes its parameter is not sharded on (each rank's loss is its share of
the global one, so the ranks' sum is the global gradient). The batch:
every rank builds the same global batch from the seed and `put_batch`
keeps its rows, row block r of P(('data', 'expert')).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from . import collectives as C

# Parameter names whose leading dim is the expert dim.
EXPERT_PARAM_NAMES = (
    "keys", "values", "bias",
    "experts_w1", "experts_b1", "experts_w2", "experts_b2",
    "experts_w3",  # Mixtral SwiGLU gate bank (MixtralMoELayer)
)


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One mesh axis as this rank sees it: its name, size, this rank's
    index along it, the ranks of its group (in index order) and the
    process group (None when the size is 1)."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[object] = None


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """The ('data', 'expert') grid of ranks. `axis(name)` for 'data',
    'expert' or 'world' (all ranks)."""

    axis_names = ("data", "expert")

    def __init__(self, n_expert: int = 1):
        world, rank = _world()
        if world % n_expert != 0:
            raise ValueError(f"{world} devices not divisible by "
                             f"expert={n_expert} x seq=1")
        n_data = world // n_expert
        self.shape = {"data": n_data, "expert": n_expert}
        self.size, self.rank = world, rank
        d, e = divmod(rank, n_expert)
        rows = [tuple(i * n_expert + j for j in range(n_expert))
                for i in range(n_data)]
        cols = [tuple(i * n_expert + j for i in range(n_data))
                for j in range(n_expert)]
        self._axes = {
            "expert": self._axis("expert", rows, d, e),
            "data": self._axis("data", cols, e, d),
            "world": Axis("world", world, rank, tuple(range(world)),
                          dist.group.WORLD if world > 1 else None),
        }

    @staticmethod
    def _axis(name, groups, mine, index) -> Axis:
        """Every rank creates every group of the axis, in one order."""
        made = None
        for i, ranks in enumerate(groups):
            g = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if i == mine:
                made = Axis(name, len(ranks), index, ranks, g)
        return made

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    @property
    def is_distributed(self) -> bool:
        return self.size > 1

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, "
                f"expert={self.shape['expert']}, rank={self.rank})")


def make_mesh(n_expert: int = 1, n_seq: int = 1) -> Mesh:
    """Mesh with ('data', 'expert') axes over the ranks of the process
    group (one rank without one); the expert axis has n_expert ranks."""
    if n_seq > 1:
        raise NotImplementedError(
            f"n_seq={n_seq}: sequence parallelism is not ported (ROADMAP "
            "item 1.7b, ring attention)")
    return Mesh(n_expert)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(s) for s in leaf.shape)


def param_spec(path_names: Sequence[str], leaf, fsdp_size: int = 1,
               fsdp_min_size: int = 2**16) -> Tuple:
    """JAX's sharding rule for one parameter keyed by its path (the last
    name) and its shape in JAX's layout: a tuple with the axis name or
    None per dim, () when replicated (JAX's PartitionSpec is a tuple)."""
    name = path_names[-1] if path_names else ""
    shape = _shape(leaf)
    ndim, size = len(shape), int(np.prod(shape)) if shape else 1
    if name in EXPERT_PARAM_NAMES and ndim >= 1:
        return ("expert",) + (None,) * (ndim - 1)
    if fsdp_size > 1 and ndim >= 1 and size >= fsdp_min_size:
        for i in sorted(range(ndim), key=lambda i: -shape[i]):
            if shape[i] % fsdp_size == 0:
                spec = [None] * ndim
                spec[i] = "data"
                return tuple(spec)
    return ()


def _jax_layout(module: nn.Module, pname: str, p: torch.Tensor
                ) -> Tuple[str, Tuple[int, ...], List[int]]:
    """(JAX leaf name, JAX shape, torch dim of each JAX dim) of a
    parameter (the inverse of `convert.from_jax_params`)."""
    shape = tuple(p.shape)
    if isinstance(module, nn.Linear) and pname == "weight":
        return "kernel", shape[::-1], [1, 0]
    if isinstance(module, nn.Conv2d) and pname == "weight":
        return "kernel", (shape[2], shape[3], shape[1], shape[0]), \
            [2, 3, 1, 0]
    if isinstance(module, nn.Embedding) and pname == "weight":
        return "embedding", shape, list(range(len(shape)))
    if isinstance(module, nn.LayerNorm) and pname == "weight" \
            and module.bias is not None:
        return "scale", shape, list(range(len(shape)))
    return pname, shape, list(range(len(shape)))


def canonical_name(name: str) -> str:
    """A parameter's name as an unsharded model has it ('a._sharded.w'
    -> 'a.w')."""
    return ".".join(p for p in name.split(".") if p != "_sharded")


def _param_owners(model: nn.Module):
    """(canonical name, owning module, its attribute name, tensor) of
    every parameter; a gathered one's tensor is a meta tensor of its full
    shape (reading it would gather it)."""
    out = []
    place = placements(model)
    for mname, mod in model.named_modules():
        if "_sharded" in mname.split("."):
            continue
        items = [(k, v) for k, v in mod._parameters.items() if v is not None]
        shards = mod._modules.get("_sharded")
        if shards is not None:
            for k, t in shards._parameters.items():
                full = f"{mname}.{k}" if mname else k
                items.append((k, torch.empty(place[full].full_shape,
                                             device="meta", dtype=t.dtype)))
        for pname, t in items:
            full = f"{mname}.{pname}" if mname else pname
            out.append((full, mod, pname, t))
    return out


def make_param_shardings(mesh: Mesh, model: nn.Module, fsdp: bool = False,
                         fsdp_min_size: int = 2**16) -> Dict[str, Tuple]:
    """Canonical parameter name -> its spec over the port's dims (an axis
    name or None per dim; () replicated), JAX's `param_spec` read on the
    parameter's JAX layout."""
    fsdp_size = mesh.shape["data"] if fsdp else 1
    out = {}
    for name, mod, pname, t in _param_owners(model):
        jname, jshape, to_torch = _jax_layout(mod, pname, t)
        spec = param_spec([jname], torch.empty(jshape, device="meta"),
                          fsdp_size, fsdp_min_size)
        if not spec:
            out[name] = ()
            continue
        mine = [None] * t.dim()
        for jd, ax in enumerate(spec):
            mine[to_torch[jd]] = ax
        out[name] = tuple(mine)
    return out


def batch_sharding(mesh: Mesh) -> Tuple:
    """The batch's spec: dim 0 over the whole mesh, data-major."""
    return (("data", "expert"),)


def replicated(mesh: Mesh) -> Tuple:
    return ()


def local_rows(n_rows: int, mesh: Mesh, n_microbatch: int = 1
               ) -> np.ndarray:
    """The global rows this rank holds: row block r of each of the
    `n_microbatch` consecutive slices of the batch (one slice: block r of
    the batch, JAX's P(('data', 'expert'))), so the rank's microbatch i
    is its part of JAX's microbatch i."""
    w, r = mesh.size, mesh.rank
    if n_rows % (w * n_microbatch):
        raise ValueError(f"batch {n_rows} must be divisible by the number "
                         f"of devices ({w}) x {n_microbatch} microbatches; "
                         f"the global batch is sharded over the full mesh")
    m = n_rows // n_microbatch
    per = m // w
    return np.concatenate([np.arange(i * m + r * per, i * m + (r + 1) * per)
                           for i in range(n_microbatch)])


def put_batch(batch, mesh: Mesh, n_microbatch: int = 1):
    """This rank's rows of a global batch (numpy array, tensor, or a dict
    of them with the batch on dim 0), as `local_rows` picks them."""
    if isinstance(batch, dict):
        return {k: put_batch(v, mesh, n_microbatch) if v is not None
                else None for k, v in batch.items()}
    if mesh.size == 1:
        return batch
    rows = local_rows(batch.shape[0], mesh, n_microbatch)
    if isinstance(batch, torch.Tensor):
        return batch[torch.as_tensor(rows, device=batch.device)]
    return np.asarray(batch)[rows]


# ---------------------------------------------------------------------------
# applying the placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Placement:
    """How a parameter lies on this rank: its spec, and where sharded the
    dim, the axis and the full shape."""

    spec: Tuple
    dim: Optional[int] = None
    axis: Optional[Axis] = None
    full_shape: Optional[Tuple[int, ...]] = None


class _Shards(nn.Module):
    """This rank's shards of a module's gathered parameters (`where`:
    name -> (axis, dim)); `folds`: name -> a function applied to the
    gathered tensor (LoRA's fold, `train/lora.py`)."""

    def __init__(self):
        super().__init__()
        self.where: Dict[str, Tuple[Axis, int]] = {}
        self.folds: Dict[str, object] = {}


def _gathered(name: str) -> property:
    def get(self):
        shards = self._modules["_sharded"]
        axis, dim = shards.where[name]
        full = C.all_gather(shards._parameters[name], axis, dim)
        fold = shards.folds.get(name)
        return full if fold is None else fold(full)
    return property(get)


def gather_on_use(mod: nn.Module, pname: str, axis: Axis, dim: int) -> None:
    """Keep this rank's shard of `mod.<pname>` along `dim`; reading the
    attribute all-gathers it over `axis` (differentiably: the gradient
    reduce-scatters to the shard). The module's class becomes a subclass
    of its own that holds the property (as torch.nn.utils.parametrize
    does; a parametrization cannot be named `keys` or `values`)."""
    full = mod._parameters.pop(pname)
    if "_sharded" not in mod._modules:
        mod.add_module("_sharded", _Shards())
        cls = mod.__class__
        mod.__class__ = type(cls.__name__, (cls,), {})
    shards = mod._modules["_sharded"]
    shards.register_parameter(pname, nn.Parameter(
        _shard_of(full, axis, dim), requires_grad=full.requires_grad))
    shards.where[pname] = (axis, dim)
    setattr(mod.__class__, pname, _gathered(pname))


def sharded_holder(mod: nn.Module, pname: str):
    """The `_Shards` holding `mod.<pname>`'s shard, or None."""
    shards = mod._modules.get("_sharded")
    return shards if shards is not None and pname in shards.where else None


def _shard_of(full: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    n = full.shape[dim]
    if n % axis.size:
        raise ValueError(f"dim {dim} of {tuple(full.shape)} does not divide "
                         f"over the {axis.size} ranks of '{axis.name}'")
    s = n // axis.size
    return full.detach().narrow(dim, axis.index * s, s).clone()


def _ep_reads(mod: nn.Module, pname: str) -> bool:
    """Does the expert-parallel dispatch read this bank as a shard? A MoE
    layer's expert bank whose impl dispatches through it."""
    return (pname in EXPERT_PARAM_NAMES and getattr(mod, "impl", None)
            in ("auto", "ep") and hasattr(mod, "n_experts"))


def shard_params(model: nn.Module, mesh: Mesh, fsdp: bool = False,
                 fsdp_min_size: int = 2**16, ep: bool = False
                 ) -> Dict[str, Placement]:
    """Shard `model`'s parameters in place as `make_param_shardings` says
    (every rank must hold the same full weights first: build them from
    one seed). `ep`: the expert-parallel context is active, so the banks
    it reads stay shards. Returns the placements (also `placements(model)`)."""
    specs = make_param_shardings(mesh, model, fsdp, fsdp_min_size)
    placed: Dict[str, Placement] = {}
    for name, mod, pname, t in _param_owners(model):
        spec = specs[name]
        axes = [a for a in spec if a is not None]
        if not axes or mesh.shape[axes[0]] == 1:
            placed[name] = Placement(spec=spec)
            continue
        dim = spec.index(axes[0])
        axis = mesh.axis(axes[0])
        if ep and axes[0] == "expert" and _ep_reads(mod, pname):
            setattr(mod, pname, nn.Parameter(_shard_of(t, axis, dim),
                                             requires_grad=t.requires_grad))
        else:
            gather_on_use(mod, pname, axis, dim)
        placed[name] = Placement(spec, dim, axis, tuple(t.shape))
    model._placements = placed
    return placed


def placements(model: nn.Module) -> Dict[str, Placement]:
    """The placements `shard_params` made ({} for an unsharded model)."""
    return getattr(model, "_placements", {})


def named_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{canonical name: the parameter this rank holds (a shard where
    sharded)}: the names an unsharded model's `named_parameters` gives."""
    return {canonical_name(k): p for k, p in model.named_parameters()}


def shard_axes(model: nn.Module) -> Dict[str, Tuple[Axis, int]]:
    """{canonical name: (axis, dim)} of the sharded parameters."""
    return {k: (p.axis, p.dim) for k, p in placements(model).items()
            if p.axis is not None}


def reduce_gradients(model: nn.Module, mesh: Mesh,
                     grads: Dict[str, torch.Tensor]) -> None:
    """Sum each gradient, in place, over the mesh axes its parameter is
    not sharded on: replicated ones over the world, expert banks over
    'data', FSDP shards over 'expert'."""
    if not mesh.is_distributed:
        return
    place = placements(model)
    by_axis: Dict[str, list] = {"world": [], "data": [], "expert": []}
    for k, g in grads.items():
        spec = place[k].spec if k in place else ()
        held = {a for a in spec if a is not None}
        rest = [a for a in ("data", "expert") if a not in held]
        key = "world" if len(rest) == 2 else (rest[0] if rest else None)
        if key is not None:
            by_axis[key].append(g)
    for key, ts in by_axis.items():
        C.all_reduce_(ts, mesh.axis(key), op=f"grad_{key}")


# ---------------------------------------------------------------------------
# full (gathered) state
# ---------------------------------------------------------------------------

def gather_full(t: torch.Tensor, p: Optional[Placement]) -> torch.Tensor:
    """The full tensor of a sharded one (every rank of its axis takes
    part); a replicated one as it is."""
    if p is None or p.axis is None:
        return t
    return C.raw_all_gather(t.detach(), p.axis, p.dim)


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state as an unsharded model's `state_dict` gives it:
    canonical names, full tensors (collective: every rank calls it)."""
    place = placements(model)
    out = {}
    for k, v in model.state_dict().items():
        name = canonical_name(k)
        out[name] = gather_full(v, place.get(name))
    return out


@torch.no_grad()
def load_full_state_dict(model: nn.Module,
                         state: Dict[str, torch.Tensor]) -> None:
    """Load a full state (`full_state_dict`'s, or an unsharded model's)
    into a sharded model: each rank copies its shards."""
    place = placements(model)
    mine = model.state_dict()
    for k, dst in mine.items():
        name = canonical_name(k)
        src = state[name]
        p = place.get(name)
        if p is not None and p.axis is not None:
            src = _shard_of(src, p.axis, p.dim)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: the state holds {tuple(src.shape)}, "
                             f"the model {tuple(dst.shape)}")
        dst.copy_(src)
    missing = set(state) - {canonical_name(k) for k in mine}
    if missing:
        raise KeyError(f"state names the model lacks: {sorted(missing)[:8]}")
