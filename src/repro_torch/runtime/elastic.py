"""Elastic scaling: reshard a live training state onto a new mesh.

Counterpart of ``repro.runtime.elastic``. On a real cluster this is the
preemption-resize path: a pod goes away, the job re-forms on (say) half
the slices, reloads the latest checkpoint with the new shardings
(``CheckpointStore.load(shardings=...)``), and continues with a re-lowered
step. The meshes are ``torch.distributed`` ``DeviceMesh``es with the
sharding rules' axis names, and a placed state is DTensors
(``torch.distributed.tensor``); ``sharding.rules.placements`` turns each
leaf's ``PartitionSpec`` into DTensor placements.

``state_shardings`` is pure: it takes ``AbstractMesh``es as well. Its
``NamedSharding``s hold the mesh they were given, so those of a
``DeviceMesh`` carry what ``reshard_state`` and the store need to place a
leaf. One process and one card work too: a ``(1, 1)`` mesh over a
world-size-1 group.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree
from repro_torch.sharding import rules
from repro_torch.sharding.mesh import AbstractMesh


def state_shardings(state_shape, mesh, cfg: ModelConfig):
    """``{"params", "opt", "ef"}`` (as the state has them) of
    ``NamedSharding``s over ``mesh``, by the reference's rules."""
    abstract = AbstractMesh.of(mesh)
    out = {"params": rules.param_shardings(state_shape["params"], abstract,
                                           cfg)}
    if "opt" in state_shape:
        out["opt"] = rules.opt_shardings(state_shape["opt"],
                                         state_shape["params"], abstract, cfg)
    if "ef" in state_shape:
        out["ef"] = rules.param_shardings(state_shape["ef"], abstract, cfg)
    if hasattr(mesh, "mesh_dim_names"):        # a DeviceMesh
        out = tree.map_leaves(lambda s: rules.NamedSharding(mesh, s.spec),
                              out)
    return out


def place(leaf, sharding):
    """``leaf`` (a plain tensor or a DTensor) as a DTensor on
    ``sharding.mesh``, a ``DeviceMesh``, with ``sharding``'s placements.

    A plain tensor is split by ``distribute_tensor``; a DTensor on the same
    mesh is ``redistribute``d. DTensor moves data within one mesh only, so
    a DTensor on another mesh is gathered whole first (``full_tensor``)
    and then split onto the new one."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh = sharding.mesh
    pl = rules.placements(sharding, mesh)
    if isinstance(leaf, DTensor):
        if leaf.device_mesh == mesh:
            return leaf.redistribute(mesh, pl)
        leaf = leaf.full_tensor()
    return distribute_tensor(leaf, mesh, pl)


def place_tree(tree_, shardings):
    """Every leaf of ``tree_`` placed by the matching ``shardings`` leaf."""
    flat, treedef = tree.flatten_with_path(tree_)
    return tree.unflatten(treedef, [
        place(leaf, sh) for (_, leaf), sh in zip(flat, tree.leaves(shardings))])


def reshard_state(state, new_mesh, cfg: ModelConfig) -> Any:
    """Move a live state (plain tensors or DTensors) onto ``new_mesh``, a
    ``DeviceMesh`` (elastic up/down-scale)."""
    return place_tree(state, state_shardings(state, new_mesh, cfg))


class _LikeGSPMD(TorchDispatchMode):
    """Ops on DTensors with the layouts GSPMD would give them.

    GSPMD, which places the reference's steps, reshards whatever layout an
    op needs; DTensor refuses or degrades a few that the port's model code
    meets. This mode sees each op on DTensors first and:

    * runs an op that DTensor refuses on its arguments gathered over as
      few mesh dims as it takes (``_gathered``): a view that unflattens a
      dim split over more ranks than it has heads, an op with no sharding
      strategy (``searchsorted`` in the MoE dispatch). The values are the
      same, at the cost of the gathers. An op that writes into one of its
      arguments writes into the whole target and each rank keeps its
      block (``_gathered_write``); into a plain tensor, which counts as
      replicated, it writes the whole values of its DTensor arguments;
    * keeps a batch split when a view cuts it into microbatches
      (``_split_rows``) and when one microbatch is selected
      (``_split_next``);
    * reduces the masked partial result of a gather from a split dim at
      once (``_reduce_partial``), and a ``logsumexp``, softmax or softmax
      gradient over a split dim by partial maxima and sums
      (``_BY_PARTIALS``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func._schema.is_mutable and args \
                and not isinstance(args[0], DTensor):
            # a write into a plain (replicated) tensor: of whole values
            return func(*_map(_full, args), **_map(_full, kwargs))
        if func is torch.ops.aten.select.int:
            args = (_split_next(*args[:2]),) + tuple(args[1:])
        if func in _BY_PARTIALS:
            fn, t, d = _BY_PARTIALS[func]
            if _split_on(args[t], args[d]):
                with _LikeGSPMD():        # the rule's own ops, likewise
                    return fn(*args, **kwargs)
        if func is torch.ops.aten._softmax_backward_data.default:
            args = (_like(args[0], args[1]),) + tuple(args[1:])
        try:
            out = func(*args, **kwargs)
        except _REFUSALS:
            if func._schema.is_mutable:
                if any(p.is_partial() for p in args[0].placements):
                    raise
                return _gathered_write(func, args, kwargs)
            out = _gathered(func, args, kwargs)
        if func is torch.ops.aten.gather.default:
            return _reduce_partial(out)
        if func in _VIEWS:
            return _split_rows(args[0], out)
        return out


# what DTensor raises for an op or layout it cannot handle
_REFUSALS = (RuntimeError, NotImplementedError, IndexError, AssertionError)


def _gathered_write(func, args, kwargs):
    """An in-place ``func`` into DTensor ``args[0]`` that DTensor refuses
    (``index_put_`` has no sharding strategy in some PyTorch versions): it
    writes into the whole target, from the whole values of its other
    arguments, and each rank keeps its own block of the result in place."""
    from torch.distributed.tensor import distribute_tensor
    target = args[0]
    whole = target.full_tensor()
    func(whole, *_map(_full, args[1:]), **_map(_full, kwargs))
    block = distribute_tensor(whole, target.device_mesh, target.placements,
                              src_data_rank=None)
    target._local_tensor.copy_(block._local_tensor)
    return target


def _gathered(func, args, kwargs):
    """``func`` on its DTensor arguments gathered over as few mesh dims as
    it takes: over the last mesh dim (the tensor-parallel ``model`` axis)
    first, then over more leading ones, so a batch split over ``data``
    stays split where it can; failing all, on the whole tensors, its
    result a replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(a.device_mesh for a in _leaves((args, kwargs))
                if isinstance(a, DTensor))
    for keep in range(mesh.ndim - 1, -1, -1):
        def loosen(x):
            if not isinstance(x, DTensor):
                return x
            pl = list(x.placements[:keep]) + [Replicate()] * (mesh.ndim - keep)
            return x.redistribute(x.device_mesh, pl)
        try:
            return func(*_map(loosen, args), **_map(loosen, kwargs))
        except _REFUSALS:
            pass

    def wrap(x):
        if isinstance(x, torch.Tensor) and not isinstance(x, DTensor):
            return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        return x
    return _map(wrap, func(*_map(_full, args), **_map(_full, kwargs)))


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)


def _split_rows(x, out):
    """``out``, a view of ``x`` that splits ``x``'s dim 0 in two, split on
    its dim 1 where ``x`` was split on dim 0 and ``out`` is whole.

    That view is how a train step cuts a batch into microbatches. GSPMD
    keeps such a view split (over both new dims); DTensor cannot split one
    mesh dim over two tensor dims, so it gathers the rows on every rank.
    Splitting the second dim keeps each rank's share of every microbatch,
    as GSPMD's microbatch scan does."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor) or not isinstance(out, DTensor) \
            or out.ndim != x.ndim + 1 \
            or out.shape[0] * out.shape[1] != x.shape[0]:
        return out
    pl = list(out.placements)
    for m, p in enumerate(x.placements):
        if p == Shard(0) and pl[m].is_replicate() \
                and out.shape[1] % x.device_mesh.size(m) == 0:
            pl[m] = Shard(1)
    return out if pl == list(out.placements) else out.redistribute(
        out.device_mesh, pl)


def _split_next(x, dim: int):
    """``x`` with a split of ``dim`` moved to ``dim + 1`` where that dim
    divides: selecting one index of a split dim leaves DTensor a partial
    result on every rank, where GSPMD moves the split to the next dim
    first, so each rank keeps its share of the selected slice."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    pl = list(x.placements)
    for m, p in enumerate(pl):
        if p == Shard(dim) and dim + 1 < x.ndim \
                and x.shape[dim + 1] % x.device_mesh.size(m) == 0:
            pl[m] = Shard(dim + 1)
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def _split_on(x, dims) -> bool:
    """Whether DTensor ``x`` is split on any of ``dims`` (over a mesh dim
    of more than one rank)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return False
    dims = {d % x.ndim for d in (dims if isinstance(dims, (list, tuple))
                                 else (dims,))}
    return any(p.is_shard() and p.dim in dims and x.device_mesh.size(m) > 1
               for m, p in enumerate(x.placements))


def _logsumexp(x, dims, keepdim: bool = False):
    m = torch.amax(x, dims, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.sum(torch.exp(x - m), dims, keepdim=keepdim)
    # the max over the kept size-1 dims drops them, as squeeze would
    return torch.log(s) + (m if keepdim else torch.amax(m, dims))


def _softmax(x, dim: int, half_to_float: bool = False):
    e = torch.exp(x - torch.amax(x, dim, keepdim=True))
    return e / torch.sum(e, dim, keepdim=True)


def _softmax_backward(grad, out, dim: int, input_dtype):
    g = out * (grad - torch.sum(grad * out, dim, keepdim=True))
    return g.to(input_dtype)


# reductions over a split dim as GSPMD runs them: partial max and sum
# results reduced across the split, where DTensor would gather the whole
# input on every rank first. The attention softmax over the key positions
# and cross_entropy's logsumexp over the vocabulary meet this.
# (op: its rule, the argument that is reduced, the argument of its dims)
_BY_PARTIALS = {
    torch.ops.aten.logsumexp.default: (_logsumexp, 0, 1),
    torch.ops.aten._softmax.default: (_softmax, 0, 1),
    torch.ops.aten._softmax_backward_data.default: (_softmax_backward, 1, 2),
}


def _like(x, ref):
    """DTensor ``x`` in ``ref``'s placements. The softmax gradient arrives
    split over the key positions while the softmax output is split over
    the query positions; GSPMD moves the gradient over (an all-to-all),
    where DTensor would gather both whole."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(x, DTensor) and isinstance(ref, DTensor)) \
            or x.placements == ref.placements:
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def _reduce_partial(x):
    """``x`` with its partial sums reduced (``Replicate`` in their place).
    A gather from a split dim leaves a masked partial result whose mask
    DTensor cannot apply once a later op has dropped a dim (the ``[..., 0]``
    after the gold-logit gather of ``cross_entropy``); the reduce is of the
    gathered values only, as GSPMD's is."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def _map(fn, x):
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, y) for y in x)
    if isinstance(x, dict):
        return {k: _map(fn, v) for k, v in x.items()}
    return fn(x)


def _leaves(x):
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _leaves(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _leaves(y)
    else:
        yield x


@contextlib.contextmanager
def on_mesh():
    """The context a step runs in on DTensors: plain tensors count as
    replicated (``implicit_replication``), and the ops DTensor refuses or
    degrades get GSPMD's layouts (``_LikeGSPMD``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), _LikeGSPMD():
        yield


def relower_train_step(train_step, state, batch_shape, new_mesh,
                       cfg: ModelConfig) -> Callable:
    """The step for ``new_mesh``'s shardings (the reference re-jits it with
    ``in_shardings=(sh, b_sh), out_shardings=(sh, None)``): the batch is
    placed by ``batch_shardings``, the step runs on DTensors under
    ``on_mesh()`` (the plain tensors the model makes, such as positions
    and masks, are the same on every rank), and the new state
    comes back in ``state_shardings``' placements, the metrics as plain
    tensors (``full_tensor()``)."""
    from torch.distributed.tensor import DTensor
    sh = state_shardings(state, new_mesh, cfg)
    b_sh = tree.map_leaves(
        lambda s: rules.NamedSharding(new_mesh, s.spec),
        rules.batch_shardings(batch_shape, AbstractMesh.of(new_mesh)))

    def step(state, batch):
        batch = place_tree(batch, b_sh)
        with on_mesh():
            new_state, metrics = train_step(state, batch)
        new_state = place_tree(new_state, sh)
        return new_state, {k: v.full_tensor() if isinstance(v, DTensor)
                           else v for k, v in metrics.items()}
    return step
