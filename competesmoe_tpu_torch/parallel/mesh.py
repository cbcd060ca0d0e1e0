"""The rank grid and the placement of parameters and batches (port of
competesmoe_tpu/parallel/mesh.py).

JAX's mesh has axes ('data', 'expert') (and a trailing 'seq' for
sequence parallelism, or ('data', 'model') for tensor-parallel serving)
over the devices of every host, and `jit` partitions one global program
over it. Here each rank is a process with its own rows of the batch, and
`Mesh` is the same grid of ranks in JAX's device order: rank r sits at
the row-major coordinates of r (`devices.reshape(*shape)`). It holds this
rank's coordinates and, per axis (and per pair of axes of a 3-axis
mesh), the process group of the ranks that share its other coordinates
(`Axis`); every rank creates every group, in one order.

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
keeps its rows, row block r of P(('data', 'expert')); the ranks of a
'seq' axis hold the same rows and take their block of the sequence
(`seq_block`). The serving placements (`decoder_param_shardings`,
`llava_param_shardings`, `ep_param_shardings`, `kv_cache_sharding`) are
JAX's specs, applied by projection where a multi-controller rank must
compute its part alone (fused projections split part by part, `Parts`);
`parallel/tensor_parallel.py` applies them to a model.
"""

from __future__ import annotations

import dataclasses
import itertools
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
    """One mesh axis (or a product of axes) as this rank sees it: its
    name, size, this rank's index along it, the ranks of its group (in
    index order) and the process group (None when the size is 1)."""

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
    """A grid of ranks with named axes, in JAX's device order: rank r
    sits at the row-major coordinates of r in the grid
    (`devices.reshape(*shape)`). `axis(name)` gives one axis, 'world' all
    ranks, and a tuple of names the product of those axes (the ranks that
    share this rank's other coordinates; index row-major over the
    names). Every rank creates every group, in one order."""

    def __init__(self, names: Sequence[str] = ("data", "expert"),
                 sizes: Optional[Sequence[int]] = None):
        world, rank = _world()
        names = tuple(names)
        sizes = list(sizes) if sizes is not None else [0] * len(names)
        known = int(np.prod([s for s in sizes if s])) if any(sizes) else 1
        sizes = [s or world // known for s in sizes]
        if int(np.prod(sizes)) != world:
            raise ValueError(f"mesh {dict(zip(names, sizes))} needs "
                             f"{int(np.prod(sizes))} devices, have {world}")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.size, self.rank = world, rank
        self.coords = dict(zip(names, np.unravel_index(rank, sizes)))
        self._axes: Dict = {}
        grid = np.arange(world).reshape(sizes)
        combos = [(n,) for n in names]
        if len(names) > 2:
            combos += [c for c in itertools.combinations(names, 2)]
        for combo in combos:
            self._axes[combo if len(combo) > 1 else combo[0]] = \
                self._product_axis(grid, combo)
        self._axes["world"] = Axis("world", world, rank, tuple(range(world)),
                                   dist.group.WORLD if world > 1 else None)

    def _product_axis(self, grid, combo) -> Axis:
        """The groups of ranks varying along the axes `combo` (every rank
        creates every one, in one order), and this rank's."""
        names = self.axis_names
        keep = [names.index(n) for n in combo]
        rest = [i for i in range(len(names)) if i not in keep]
        moved = np.transpose(grid, rest + keep).reshape(
            int(np.prod([grid.shape[i] for i in rest])) if rest else 1, -1)
        made = None
        for row in moved:
            ranks = tuple(int(r) for r in row)
            g = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if self.rank in ranks:
                made = Axis("x".join(combo), len(ranks),
                            ranks.index(self.rank), ranks, g)
        return made

    def axis(self, name) -> Axis:
        if isinstance(name, (tuple, list)):
            names = tuple(n for n in self.axis_names if n in name)
            if len(names) == len(self.axis_names):
                return self._axes["world"]
            if len(names) == 1:
                return self._axes[names[0]]
            return self._axes[names]
        return self._axes[name]

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The axes the batch rows are split over (JAX's
        P(('data', 'expert')), or 'data' on a tensor-parallel mesh); a
        'seq' axis splits the sequence instead."""
        return tuple(n for n in self.axis_names if n in ("data", "expert"))

    @property
    def is_distributed(self) -> bool:
        return self.size > 1

    def __repr__(self) -> str:
        dims = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({dims}, rank={self.rank})"


def make_mesh(n_expert: int = 1, n_seq: int = 1) -> Mesh:
    """Mesh with ('data', 'expert') axes over the ranks of the process
    group (one rank without one); the expert axis has n_expert ranks.
    n_seq > 1 adds a trailing 'seq' axis of n_seq ranks for sequence
    parallelism (`parallel/ring_attention.py`)."""
    world, _ = _world()
    if world % (n_expert * n_seq) != 0:
        raise ValueError(f"{world} devices not divisible by "
                         f"expert={n_expert} x seq={n_seq}")
    if n_seq > 1:
        return Mesh(("data", "expert", "seq"),
                    (world // (n_expert * n_seq), n_expert, n_seq))
    return Mesh(("data", "expert"), (world // n_expert, n_expert))


def make_tp_mesh(n_model: int = 1) -> Mesh:
    """Mesh with ('data', 'model') axes for tensor-parallel decode."""
    world, _ = _world()
    if world % n_model != 0:
        raise ValueError(f"{world} devices not divisible by model={n_model}")
    return Mesh(("data", "model"), (world // n_model, n_model))


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


def _batch_rank(mesh: Mesh) -> Tuple[int, int]:
    """(ranks the rows are split over, this rank's index among them):
    row-major over the mesh's batch axes."""
    w, r = 1, 0
    for n in mesh.batch_axes:
        w, r = w * mesh.shape[n], r * mesh.shape[n] + int(mesh.coords[n])
    return w, r


def local_rows(n_rows: int, mesh: Mesh, n_microbatch: int = 1
               ) -> np.ndarray:
    """The global rows this rank holds: row block r of each of the
    `n_microbatch` consecutive slices of the batch (one slice: block r of
    the batch, JAX's P(('data', 'expert'))), so the rank's microbatch i
    is its part of JAX's microbatch i. The ranks of a 'seq' axis hold
    the same rows (and split their sequence, `seq_block`)."""
    w, r = _batch_rank(mesh)
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


def seq_block(x, mesh: Optional[Mesh], dim: int = 1):
    """This rank's block of dim `dim` (the sequence) over the mesh's 'seq'
    axis, in rank order; x itself without one."""
    if mesh is None or mesh.shape.get("seq", 1) == 1:
        return x
    n, i = mesh.shape["seq"], int(mesh.coords["seq"])
    T = x.shape[dim]
    if T % n:
        raise ValueError(f"sequence {T} does not divide over the {n} "
                         f"ranks of 'seq'")
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, i * (T // n), T // n)
    return np.take(x, np.arange(i * (T // n), (i + 1) * (T // n)), axis=dim)


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
    'data' (and 'seq'), FSDP shards over 'expert' (and 'seq')."""
    if not mesh.is_distributed:
        return
    place = placements(model)
    by_axes: Dict[Tuple[str, ...], list] = {}
    for k, g in grads.items():
        spec = place[k].spec if k in place else ()
        held = {a for a in spec if a is not None}
        rest = tuple(a for a in mesh.axis_names
                     if a not in held and mesh.shape[a] > 1)
        if rest:
            by_axes.setdefault(rest, []).append(g)
    for key in sorted(by_axes):
        ax = mesh.axis(key)
        C.all_reduce_(by_axes[key], ax, op=f"grad_{ax.name}")


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


# ---------------------------------------------------------------------------
# tensor- and expert-parallel serving placements (JAX's mesh.py:125-221)
# ---------------------------------------------------------------------------

# Megatron-style rules for the llama/phi decoder: column-parallel layers
# shard their OUTPUT features, row-parallel ones their INPUT features
_TP_COL = ("qkv_proj", "q_proj", "k_proj", "v_proj",
           "gate_up_proj", "gate_proj", "up_proj", "lm_head")
_TP_ROW = ("o_proj", "down_proj")


@dataclasses.dataclass(frozen=True)
class Parts:
    """A spec entry for a fused projection's output dim: the dim holds
    parts of `sizes` (q, k, v or gate, up) and each part splits over
    `axis`, rank i keeping block i of every part. A plain axis name splits
    the dim as one part; on a fused dim that would give rank 0 all of q
    and half of k, or all of gate and none of up."""

    axis: str
    sizes: Tuple[int, ...]


def split_entry(t: torch.Tensor, dim: int, entry, axis: Axis
                ) -> torch.Tensor:
    """This rank's part of `t` along `dim` under a spec entry (an axis
    name or `Parts`)."""
    sizes = entry.sizes if isinstance(entry, Parts) else (t.shape[dim],)
    starts = np.cumsum((0,) + tuple(sizes[:-1]))
    return torch.cat([_shard_of(t.narrow(dim, int(s), n), axis, dim)
                      for s, n in zip(starts, sizes)], dim)


def decoder_param_spec(path_names: Sequence[str], leaf) -> Tuple:
    """JAX's tensor-parallel spec of one decoder parameter, keyed by its
    path and read on its JAX layout (a tuple, () replicated). Only
    parameters named `kernel` and `bias` shard: a quantized projection's
    `kernel_q` and `scale` replicate. `decoder_param_shardings` applies it
    by projection."""
    module = path_names[-2] if len(path_names) >= 2 else ""
    name = path_names[-1] if path_names else ""
    ndim = len(_shape(leaf))
    if module in _TP_COL:
        if name == "kernel" and ndim == 2:
            return (None, "model")
        if name == "bias" and ndim == 1:
            return ("model",)
    if module in _TP_ROW and name == "kernel" and ndim == 2:
        return ("model", None)
    if name in EXPERT_PARAM_NAMES and ndim >= 1:
        return ("model",) + (None,) * (ndim - 1)
    return ()


def _named_specs(model: nn.Module, rule) -> Dict[str, Tuple]:
    """{canonical name: spec over the port's dims} of every parameter and
    buffer of `model`, `rule(path_names, jax_leaf)` read on its JAX
    layout."""
    out = {}
    for mname, mod in model.named_modules():
        tensors = list(mod._parameters.items()) + list(mod._buffers.items())
        for pname, t in tensors:
            if t is None:
                continue
            full = f"{mname}.{pname}" if mname else pname
            jname, jshape, to_torch = _jax_layout(mod, pname, t)
            path = mname.split(".") + [jname] if mname else [jname]
            spec = rule(path, torch.empty(jshape, device="meta"))
            mine = [None] * t.dim()
            for jd, ax in enumerate(spec):
                mine[to_torch[jd]] = ax
            out[full] = tuple(mine) if spec else ()
    return out


def _fused_parts(cfg, module: str, n_out: int) -> Optional[Tuple[int, ...]]:
    """The parts of a fused projection's output features."""
    if module == "qkv_proj":
        p = cfg.head_dim
        return (cfg.num_attention_heads * p,) + (
            cfg.num_key_value_heads * p,) * 2
    if module == "gate_up_proj":
        return (n_out // 2,) * 2
    return None


def decoder_param_shardings(mesh: Mesh, model: nn.Module
                            ) -> Dict[str, Tuple]:
    """The tensor-parallel placement of every tensor of an unplaced
    DecoderLM, on the port's dims: `decoder_param_spec` per tensor,
    applied by projection so that each rank computes its part alone
    (`tensor_parallel.shard_decoder` applies it):

    - a module's projections (an attention's q, k, v, o; an MLP's; the
      lm_head) shard together or not at all: not where one of them is
      quantized (JAX shards no `kernel_q`; its bias then replicates too),
      nor where a sharded dim, or a part of it, does not divide by
      'model', nor, for an attention, unless both h and hk do (its KV
      cache then replicates too, as JAX's engine does);
    - a fused projection's output dim splits part by part (`Parts`);
    - a row-parallel projection's bias replicates (it adds once, after
      the sum over 'model'), as in JAX;
    - an expert bank shards its experts where they divide (ndim >= 2: a
      1-D tensor named `bias` is no bank)."""
    M = mesh.shape["model"]
    cfg = model.cfg
    specs = _named_specs(model, decoder_param_spec)
    shapes = {k: tuple(v.shape) for k, v in itertools.chain(
        model.named_parameters(), model.named_buffers())}
    groups: Dict[str, Dict[str, List[str]]] = {}
    out = {}
    for name, spec in specs.items():
        mpath, _, pname = name.rpartition(".")
        parent, _, module = mpath.rpartition(".")
        if module in _TP_COL + _TP_ROW:
            groups.setdefault(parent, {}).setdefault(mpath, []).append(name)
        elif spec:
            shape = shapes[name]
            out[name] = spec if len(shape) >= 2 and shape[0] % M == 0 else ()
        else:
            out[name] = ()
    heads = (cfg.num_attention_heads % M == 0
             and cfg.num_key_value_heads % M == 0)
    for projs in groups.values():
        entries = _group_entries(cfg, projs, specs, shapes, M)
        if entries is not None and not heads and any(
                m.endswith("o_proj") for m in projs):
            entries = None                  # an attention that cannot shard
        for mpath, names in projs.items():
            for name in names:
                out[name] = () if entries is None else tuple(
                    entries[mpath] if a is not None else None
                    for a in specs[name])
    return out


def _group_entries(cfg, projs, specs, shapes, M: int):
    """{projection path: its sharded dim's entry} of one module's
    projections, or None when one of them cannot shard (quantized, or a
    part that does not divide by M)."""
    entries = {}
    for mpath in projs:
        kernel = specs.get(f"{mpath}.weight", ())
        if not kernel:                        # quantized: JAX replicates
            return None
        dim = next(i for i, a in enumerate(kernel) if a is not None)
        n = shapes[f"{mpath}.weight"][dim]
        sizes = _fused_parts(cfg, mpath.rpartition(".")[2], n) or (n,)
        if any(x % M for x in sizes):
            return None
        entries[mpath] = Parts("model", sizes) if len(sizes) > 1 else "model"
    return entries


def llava_param_shardings(mesh: Mesh, model: nn.Module) -> Dict[str, Tuple]:
    """Tensor-parallel specs of a LlavaModel: the decoder
    (`language_model`) takes `decoder_param_shardings`, the vision tower
    and projector replicate (they run once a request)."""
    out = {k: () for k in _named_specs(model, lambda path, leaf: ())}
    out.update((f"language_model.{k}", v) for k, v in
               decoder_param_shardings(mesh, model.language_model).items())
    return out


def ep_param_shardings(mesh: Mesh, model: nn.Module) -> Dict[str, Tuple]:
    """Expert-parallel serving specs: every stacked expert bank whose
    leading dim divides by the 'expert' axis shards over it (ndim >= 2,
    so 1-D `bias` parameters of norms and gates never do); the rest
    replicates."""
    n_ep = mesh.shape["expert"]

    def rule(path, leaf):
        shape = _shape(leaf)
        if (path[-1] in EXPERT_PARAM_NAMES and len(shape) >= 2
                and shape[0] % n_ep == 0):
            return ("expert",) + (None,) * (len(shape) - 1)
        return ()
    return _named_specs(model, rule)


def kv_cache_sharding(mesh: Mesh) -> Tuple:
    """The KV cache [L, B, max_len, kv_heads, head_dim]: slots over
    'data', kv heads over 'model' (where the attention shards its heads:
    a cache holds the KV heads its decoder's attention holds,
    `DecoderLM.new_cache`)."""
    return (None, "data", None, "model", None)
