"""The ('data', 'model') mesh over ``torch.distributed`` ranks, and the
sharding rules of the JAX package's ``parallel/mesh.py``.

JAX places arrays with ``NamedSharding`` s and lets GSPMD insert the
collectives. The port keeps plain local tensors on every rank and issues
the collectives itself (:mod:`.collectives`); this module holds the layout:

* :func:`make_mesh` builds a :class:`Mesh` over the initialised process
  group (``init_device_mesh(device_type, (n_data, n_model),
  mesh_dim_names=("data", "model"))``, rank = data index * n_model + model
  index, the JAX mesh's device order). With no process group it is the
  mesh of one rank without groups, on which every collective is a no-op;
  a world of 1 with a process group has groups of one rank, on which the
  collectives run (each the identity).
* The TP rules (``_TP_RULES``, :func:`param_pspec`, :func:`leaf_sharding`,
  :func:`tree_pspecs`) are the JAX package's, as data: a spec is a tuple of
  axis names or None per dim of the JAX layout, matched on the '/'-joined
  flax paths that ``io.from_jax.flax_paths`` gives every port key. A flax
  kernel is the transpose of a torch weight (``(in, out)`` vs ``(out,
  in)``; HWIO vs OIHW for convolutions), so a spec moves to the torch
  layout through :func:`jax_perm`.
* :func:`state_shardings` gives the layout of a port ``TrainState``: the TP
  rules, and with ``zero1`` the optimizer-state leaves that would
  otherwise be replicated, on the dim JAX picks (the largest dim of the JAX
  layout divisible by the data axis, the first such).
* :func:`shard_params` slices the TP-ruled weights of a model to this
  rank's part over ``model`` and switches its modules to the split
  forward; :func:`shard_batch` takes this rank's rows of a global batch;
  :func:`replicate` broadcasts from rank 0.

The port splits a module's ruled weights together or not at all (the q, k,
v and out projections of an attention layer with heads divisible by the
model axis; a SwiGLU; a SimpleDecoder block): where a dim does not divide,
the whole module stays replicated, where JAX falls back leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import re
from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import collectives as coll

Spec = Tuple[Optional[str], ...]

# parameter-path regex -> spec (JAX layout). First match wins; default
# replicated. Paths are '/'-joined flax param tree keys.
_TP_RULES = [
    # transformer SwiGLU: w1/wg split on the expanded (output) dim,
    # w2 on the contracted (input) dim
    (re.compile(r".*/ff/w1/kernel$"), (None, "model")),
    (re.compile(r".*/ff/wg/kernel$"), (None, "model")),
    (re.compile(r".*/ff/w2/kernel$"), ("model", None)),
    (re.compile(r".*/ff/w[1g]/bias$"), ("model",)),
    # attention projections: q/k/v split on heads (output dim), out on input
    (re.compile(r".*/(q|k|v)_proj/kernel$"), (None, "model")),
    (re.compile(r".*/out_proj/kernel$"), ("model", None)),
    # SimpleDecoder MLPs: alternate split
    (re.compile(r".*/block\d+_fc0/kernel$"), (None, "model")),
    (re.compile(r".*/block\d+_fc1/kernel$"), ("model", None)),
]


def param_pspec(path: str) -> Spec:
    for rx, spec in _TP_RULES:
        if rx.match(path):
            return spec
    return ()


def leaf_sharding(mesh: "Mesh", spec: Spec, leaf) -> Spec:
    """``spec`` for ``leaf`` (anything with ``.shape``, JAX layout),
    falling back to replication ``()`` when a sharded dim doesn't exist or
    doesn't divide."""
    shape = tuple(getattr(leaf, "shape", ()))
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if len(shape) <= dim or shape[dim] % mesh.shape[axis] != 0:
            return ()
    return tuple(spec)


def tree_pspecs(tree, prefix: str = ""):
    """The spec of every leaf of a nested dict keyed like a flax tree, by
    matching its path against the TP rules (default replicated); the
    same nesting. Optimizer state that mirrors the parameter tree matches
    the suffix rules too."""
    if isinstance(tree, dict):
        return {k: tree_pspecs(v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return param_pspec(prefix)


def jax_perm(path: str, ndim: int) -> Tuple[int, ...]:
    """``perm`` with ``jax_shape[i] == torch_shape[perm[i]]`` for the leaf
    at flax ``path``: Dense kernels are transposed, convolution kernels
    HWIO vs OIHW; everything else (biases, norms, embeddings, tables)
    shares its layout."""
    if path.endswith("/kernel") or path == "kernel":
        if ndim == 2:
            return (1, 0)
        if ndim == 4:
            return (2, 3, 1, 0)
    return tuple(range(ndim))


def to_torch_spec(spec: Spec, perm: Sequence[int]) -> Spec:
    """A JAX-layout spec on the torch layout (one entry per torch dim)."""
    out: list = [None] * len(perm)
    for i, axis in enumerate(spec):
        out[perm[i]] = axis
    return tuple(out)


@dataclasses.dataclass
class Mesh:
    """A ('data', 'model') mesh of ``n_data * n_model`` ranks. ``data_group``
    spans this rank's column (the ranks that share its model index),
    ``model_group`` its row. A mesh made without process groups (the one
    of a single process, or a layout for :func:`state_shardings`) has
    None groups, on which every collective is a no-op."""
    n_data: int = 1
    n_model: int = 1
    device_type: str = "cpu"
    data_group: object = None
    model_group: object = None
    data_rank: int = 0
    model_rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.n_data, "model": self.n_model}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over the process group's ranks (one process
    per device). ``n_data=None`` means ``world // n_model``. ``devices``
    (a sequence as long as the ranks to use) stands for JAX's device
    list; the port's mesh spans the whole world, so it must be as long as
    the world. Raises ``ValueError`` where JAX asserts, and where the mesh
    leaves ranks out."""
    world = coll.world_size()
    n = len(devices) if devices is not None else world
    if n_data is None:
        n_data = n // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > n:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} ranks; there are {n}")
    if n_data * n_model != world:
        raise ValueError(f"the ({n_data}, {n_model}) mesh must span the "
                         f"world of {world} ranks")
    if not coll.initialized():
        return Mesh(1, 1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (n_data, n_model),
                          mesh_dim_names=("data", "model"))
    return Mesh(n_data, n_model, device_type,
                data_group=dm.get_group("data"),
                model_group=dm.get_group("model"),
                data_rank=dm.get_local_rank("data"),
                model_rank=dm.get_local_rank("model"))


def mesh_from_config(train_config) -> Mesh:
    """The mesh of ``TrainConfig.data_axis`` (-1: every rank over
    ``model_axis``) and ``model_axis``."""
    d = train_config.data_axis
    return make_mesh(n_data=None if d == -1 else d,
                     n_model=train_config.model_axis)


# ---------------------------------------------------------------------------
# batches and weights
# ---------------------------------------------------------------------------

def _rows(x, idx):
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(idx, device=x.device)]
    return np.asarray(x)[idx]


def batch_rows(batch_size: int, mesh: Mesh, accum_steps: int = 1
               ) -> np.ndarray:
    """The global rows this rank holds of a batch of ``batch_size``: its
    slice of each of the ``accum_steps`` micro-batches, micro-batch by
    micro-batch, as JAX reshapes the batch to ``(accum, B/accum, ...)`` and
    shards each micro-batch over ``data`` (``P(None, 'data')``)."""
    n, r = mesh.n_data, mesh.data_rank
    if batch_size % (n * accum_steps):
        raise ValueError(f"batch of {batch_size} does not split into "
                         f"{accum_steps} micro-batches over {n} ranks")
    micro = batch_size // accum_steps
    b = micro // n
    return np.concatenate([np.arange(m * micro + r * b, m * micro + (r + 1) * b)
                           for m in range(accum_steps)])


def shard_batch(batch, mesh: Mesh, accum_steps: int = 1):
    """This rank's rows (:func:`batch_rows`) of every array of ``batch``
    (a dict of numpy arrays or tensors, leading dim the global batch)."""
    if mesh.n_data == 1:
        return batch
    first = next(iter(batch.values()))
    idx = batch_rows(len(first), mesh, accum_steps)
    return {k: _rows(v, idx) for k, v in batch.items()}


def replicate(tree, mesh: Optional[Mesh] = None):
    """Broadcast every tensor of ``tree`` (an ``nn.Module``'s parameters
    and buffers, or a dict of tensors) from rank 0, in place; returns
    ``tree``."""
    if not coll.initialized():
        return tree
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        tensors = [v for v in tree.values() if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            coll.broadcast_(t.data if isinstance(t, torch.nn.Parameter)
                            else t, 0)
    return tree


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

def _paths(model: torch.nn.Module) -> Dict[str, str]:
    from ..io.from_jax import flax_paths
    return flax_paths(model.state_dict().keys())


def _global_shape(model, name: str, p: torch.Tensor) -> Tuple[int, ...]:
    shape = list(p.shape)
    tp = getattr(model, "tp_dims", {})
    if name in tp:
        shape[tp[name]] *= model.tp_size
    return tuple(shape)


def tp_plan(model: torch.nn.Module, n_model: int) -> Dict[str, int]:
    """``{parameter name: torch dim}`` of the weights split over ``model``:
    those the rules split and whose dims divide, in modules whose ruled
    weights all split (module doc). A model already sharded returns its
    own plan. On a model axis of 1 the plan is the rules' (a split into
    one part, as JAX's specs name ``model`` there too; ZeRO-1 leaves those
    leaves alone, as JAX does)."""
    if hasattr(model, "tp_dims"):
        return dict(model.tp_dims)
    paths = _paths(model)
    layout = Mesh(1, n_model)
    want = {}
    for name, p in model.named_parameters():
        spec = param_pspec(paths[name])
        if not spec:
            continue
        perm = jax_perm(paths[name], p.dim())
        jshape = tuple(p.shape[i] for i in perm)
        spec = leaf_sharding(layout, spec, SimpleNamespace(shape=jshape))
        tspec = to_torch_spec(spec, perm) if spec else ()
        want[name] = tspec.index("model") if "model" in tspec else None
    plan = {}
    for prefix, mod in model.named_modules():
        unit = getattr(mod, "tp_unit", None)
        if unit is None:
            continue
        names = [f"{prefix}.{k}" if prefix else k for k in unit(n_model)]
        if names and all(want.get(n) is not None for n in names):
            plan.update({n: want[n] for n in names})
    return plan


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Slice the TP-ruled weights of ``model`` (:func:`tp_plan`) to this
    rank's part over ``model`` and switch their modules to the split
    forward, in place. Sets ``model.tp_dims`` (name -> sliced torch dim),
    ``model.tp_size``, ``model.tp_group`` and ``model.tp_partial_grads``
    (replicated parameters whose gradient each model rank holds part of:
    a split SimpleDecoder block's first BatchNorm)."""
    if hasattr(model, "tp_dims"):
        raise ValueError("the model is already sharded")
    if mesh.n_model == 1:
        return model
    plan = tp_plan(model, mesh.n_model)
    partial = set()
    for prefix, mod in model.named_modules():
        unit = getattr(mod, "tp_unit", None)
        if unit is None:
            continue
        names = [f"{prefix}.{k}" if prefix else k
                 for k in unit(mesh.n_model)]
        if names and all(n in plan for n in names):
            partial |= {f"{prefix}.{k}" if prefix else k for k in
                        mod.shard_model_(mesh.model_group, mesh.model_rank,
                                         mesh.n_model)}
    model.tp_dims = plan
    model.tp_size = mesh.n_model
    model.tp_group = mesh.model_group
    model.tp_partial_grads = partial
    return model


def slice_tp(name: str, t: torch.Tensor, model: torch.nn.Module
             ) -> torch.Tensor:
    """This rank's part of the full tensor ``t`` of parameter ``name``
    (the tensor itself where ``name`` is not split)."""
    dims = getattr(model, "tp_dims", {})
    if name not in dims:
        return t
    d, n = dims[name], model.tp_size
    k = t.shape[d] // n
    return t.narrow(d, coll.rank(model.tp_group) * k, k)


def gather_tp(tensors: Dict[str, torch.Tensor], model: torch.nn.Module
              ) -> Dict[str, torch.Tensor]:
    """``tensors`` keyed like ``model``'s parameters with the split ones
    gathered whole over ``model`` (a collective: every rank calls it)."""
    dims = getattr(model, "tp_dims", {})
    return {k: coll.all_gather(v.contiguous(), model.tp_group, dims[k])
            if k in dims else v for k, v in tensors.items()}


# ---------------------------------------------------------------------------
# train-state layout
# ---------------------------------------------------------------------------

def zero1_dim(path: str, shape: Sequence[int], n_data: int
              ) -> Optional[int]:
    """The torch dim JAX's ZeRO-1 shards a replicated optimizer leaf of
    torch ``shape`` on: the largest dim of its JAX layout that divides
    ``n_data`` (the first of equals); None for scalars and odd shapes."""
    perm = jax_perm(path, len(shape))
    jshape = [shape[i] for i in perm]
    cands = [(d, s) for d, s in enumerate(jshape)
             if s % n_data == 0 and s >= n_data]
    if not cands:
        return None
    return perm[max(cands, key=lambda t: t[1])[0]]


def state_shardings(state, mesh: Mesh, zero1: bool = False,
                    data_axis: str = "data") -> dict:
    """The layout of a port ``TrainState`` under ``mesh``, as specs on the
    torch layout (a tuple of axis names or None per dim):
    ``{"params": {name: spec}, "opt_state": {buffer: {name: spec}}}`` over
    the optimizer's parameters and per-parameter buffers (``z``, ``mu``,
    ``nu``; the scalars stay replicated).

    The TP rules give the parameters' and their buffers' specs. With
    ``zero1`` (and more than one data rank) every optimizer buffer that
    would otherwise be replicated is split over ``data`` on
    :func:`zero1_dim`. Parameters stay replicated over ``data``: the
    forward reads them every layer. Works on a sharded model (its
    ``tp_dims``) and on a whole one (the plan ``shard_params`` would
    take)."""
    model = state.model
    paths = _paths(model)
    plan = tp_plan(model, mesh.n_model)
    n_data = mesh.shape[data_axis]
    params, opt = {}, {}
    for name, p in state.optimizer.params.items():
        shape = _global_shape(model, name, p)
        spec = [None] * len(shape)
        if name in plan:
            spec[plan[name]] = "model"
        params[name] = tuple(spec)
        ospec = list(spec)
        if zero1 and n_data > 1 and name not in plan:
            d = zero1_dim(paths[name], shape, n_data)
            if d is not None:
                ospec[d] = data_axis
        for buf in state.optimizer.BUFFERS:
            opt.setdefault(buf, {})[name] = tuple(ospec)
    return {"params": params, "opt_state": opt}


def zero1_dims(state, mesh: Mesh) -> Dict[str, int]:
    """``{parameter name: torch dim}`` of the optimizer buffers ZeRO-1
    splits over ``data`` (:func:`state_shardings` with ``zero1``)."""
    sh = state_shardings(state, mesh, zero1=True)["opt_state"]
    if not sh:
        return {}
    specs = next(iter(sh.values()))
    return {n: s.index("data") for n, s in specs.items() if "data" in s}
