"""Logical sharding rules: tree path + shape -> PartitionSpec.

Counterpart of ``repro.sharding.rules``, the same rules in the same order:

  * ``model`` axis = tensor parallelism: attention head / ffn-hidden /
    vocab dims; the MoE expert dim when divisible (expert parallelism),
    else the expert-hidden dim (TP inside experts).
  * ``data`` axis = batch AND fully sharded parameters (FSDP / ZeRO-3: the
    contraction-side dim of each weight shards over ``data``). Optimizer
    moments inherit the parameter specs.
  * ``pod`` axis (multi-pod mesh) = pure data parallelism over the batch.

Every rule is divisibility-guarded: a dim that does not divide evenly by
its target axis falls back to replication.

The rules read a mesh's axis names and sizes only, so they take the
port's ``sharding.mesh.AbstractMesh`` (the production meshes' sizes with no
devices), a ``DomainMesh`` and the meshes of ``make_mesh`` alike. A path
is the port's key tuple (``core.tree``), e.g. ``("blocks", "attn",
"wq")``: the key tuple the reference builds from ``jax.tree_util`` paths.

``placements`` turns a spec into the ``Placement``s of a
``torch.distributed`` ``DeviceMesh`` with the same axis names, for the
DTensors of ``launch.dryrun``, ``runtime.elastic`` and
``CheckpointStore.load(shardings=)``.

The reference's ``hint`` (``with_sharding_constraint``) pins a layout,
not a value, and one PyTorch process has no layout to pin, so the port
has no counterpart (``models/attention.py``).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import map_with_path


class PartitionSpec(tuple):
    """One entry a dim: None (replicated), an axis name, or a tuple of
    axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A PartitionSpec over a mesh's named axes."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """Each dim's per-device extent; raises ``ValueError`` where the
        spec's axes do not divide the dim, as ``jax.sharding`` does."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {tuple(shape)} has dims")
        out = []
        for i, dim in enumerate(shape):
            n = _axis_size(self.mesh, self.spec[i]) \
                if i < len(self.spec) else 1
            if dim % n:
                raise ValueError(f"{self.spec} splits dim {i} of "
                                 f"{tuple(shape)} {n} ways")
            out.append(dim // n)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return dict(zip(mesh.axis_names, mesh.axis_sizes))[name]


def data_axes(mesh):
    """The batch axis spec: ("pod","data") on multi-pod meshes."""
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def _fit(dim: int, axis, mesh):
    """axis if dim divides evenly, else None (replicate)."""
    return axis if axis is not None and dim % _axis_size(mesh, axis) == 0 \
        else None


def _path_keys(path) -> Tuple[str, ...]:
    return tuple(str(k).lower() for k in path)


# --------------------------------------------------------------- params
def param_spec(path, shape, mesh, cfg: ModelConfig,
               tp_only: bool = False) -> PartitionSpec:
    """``tp_only=True`` is the serving layout: weights shard over "model"
    only (no FSDP dim), so decode never gathers weights."""
    keys = _path_keys(path)
    nd = len(shape)
    last = keys[-1]
    contract_default = None if tp_only else "data"

    def two_dim(d_contract, d_out, contract_axis="data", out_axis="model"):
        """Spec for the trailing two dims; leading dims replicated."""
        if tp_only:
            contract_axis = None if contract_axis == "data" else contract_axis
            out_axis = None if out_axis == "data" else out_axis
        lead = (None,) * (nd - 2)
        return P(*lead, _fit(d_contract, contract_axis, mesh),
                 _fit(d_out, out_axis, mesh))

    # --- embeddings / head: vocab on model, feature replicated
    if last == "embed":
        return P(_fit(shape[0], "model", mesh), None)
    if last in ("head", "patch_proj", "frame_proj"):
        return P(_fit(shape[0], contract_default, mesh),
                 _fit(shape[1], "model", mesh))

    # --- MoE experts: (L, E, D, Fe) / (L, E, Fe, D)
    if "moe" in keys or "experts" in keys or last == "router":
        if last == "router":
            lead = (None,) * (nd - 2)
            return P(*lead, _fit(shape[-2], contract_default, mesh), None)
        if last in ("wi", "wg", "wo") and nd >= 3:
            e, d_in, d_out = shape[-3], shape[-2], shape[-1]
            ep = _fit(e, "model", mesh)
            lead = (None,) * (nd - 3)
            if ep is not None:      # expert parallelism
                return P(*lead, ep, _fit(d_in, contract_default, mesh), None)
            # fall back: TP inside each expert
            return P(*lead, None, _fit(d_in, contract_default, mesh),
                     _fit(d_out, "model", mesh))
        # shared expert MLP (dict under moe): the generic rules below

    # --- norms / biases / small vectors: replicate
    if nd <= 1 or "norm" in last or last in ("b", "b_i", "b_f", "bias",
                                             "conv_b", "a_log", "dt_bias",
                                             "d_skip"):
        return P(*(None,) * nd)

    # --- attention / mlp / ssm projections: contract dim on data,
    #     output-feature dim on model (flipped for the down/out projs)
    if last in ("wo", "out_proj", "down_proj"):
        return two_dim(shape[-2], shape[-1], "model", "data")
    if last in ("wq", "wk", "wv", "wi", "wg", "in_proj", "up_proj",
                "w_in", "w_if"):
        return two_dim(shape[-2], shape[-1], "data", "model")
    if last == "conv_w":            # (W, conv_dim) depthwise
        lead = (None,) * (nd - 2)
        return P(*lead, None, _fit(shape[-1], "model", mesh))
    if last == "r_rec":             # (H, dh, 4dh) block-diag recurrent
        lead = (None,) * (nd - 3)
        return P(*lead, None, None, _fit(shape[-1], "model", mesh))
    if last in ("bq", "bk", "bv"):
        lead = (None,) * (nd - 1)
        return P(*lead, _fit(shape[-1], "model", mesh))
    # default: replicate (safe)
    return P(*(None,) * nd)


def param_shardings(params_shape, mesh, cfg: ModelConfig,
                    tp_only: bool = False):
    """Nested dicts of NamedShardings matching a parameter tree (tensors on
    any device, ``meta`` included)."""
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(
            path, tuple(leaf.shape), mesh, cfg, tp_only=tp_only)),
        params_shape)


def opt_shardings(opt_shape, params_shape, mesh, cfg: ModelConfig):
    """Moments inherit the parameter specs; the step count replicates."""
    pspecs = param_shardings(params_shape, mesh, cfg)
    return {"m": pspecs, "v": pspecs, "count": NamedSharding(mesh, P())}


# ---------------------------------------------------------------- batch
def batch_shardings(batch_shape, mesh):
    dp = data_axes(mesh)

    def one(path, leaf):
        b = leaf.shape[0] if leaf.ndim else 1
        ax = dp if b % _axis_size(mesh, dp) == 0 else None
        return NamedSharding(mesh, P(ax, *(None,) * (leaf.ndim - 1)))
    return map_with_path(one, batch_shape)


# ---------------------------------------------------------------- cache
def cache_spec(path, shape, mesh, cfg: ModelConfig,
               seq_shard: bool = False) -> PartitionSpec:
    """Decode-cache leaves: (L, B, S, K, dh) KV, or recurrent states.

    Shards B over data and the KV heads over model (when divisible);
    ``seq_shard=True`` moves the model axis to the sequence dim instead.
    """
    keys = _path_keys(path)
    last = keys[-1]
    dp = data_axes(mesh)
    nd = len(shape)
    if last in ("k", "v", "attn_k", "attn_v"):
        b, s, kh = shape[-4], shape[-3], shape[-2]
        bax = dp if b % _axis_size(mesh, dp) == 0 else None
        lead = (None,) * (nd - 4)
        if seq_shard:
            return P(*lead, bax, _fit(s, "model", mesh), None, None)
        kax = _fit(kh, "model", mesh)
        if kax is not None:
            return P(*lead, bax, None, kax, None)
        return P(*lead, bax, _fit(s, "model", mesh), None, None)
    if last in ("mamba_conv", "m_conv"):        # (..., B, W-1, conv_dim)
        b, cdim = shape[-3], shape[-1]
        lead = (None,) * (nd - 3)
        bax = dp if b % _axis_size(mesh, dp) == 0 else None
        return P(*lead, bax, None, _fit(cdim, "model", mesh))
    if last in ("mamba_ssm", "m_c"):            # (..., B, H, N, P)
        b, h = shape[-4], shape[-3]
        lead = (None,) * (nd - 4)
        bax = dp if b % _axis_size(mesh, dp) == 0 else None
        hax = _fit(h, "model", mesh)
        if hax is not None:
            return P(*lead, bax, hax, None, None)
        return P(*lead, bax, None, None, _fit(shape[-1], "model", mesh))
    if last in ("s_c", "s_n", "s_h", "s_m"):    # (G, B, D)
        b, d = shape[-2], shape[-1]
        lead = (None,) * (nd - 2)
        bax = dp if b % _axis_size(mesh, dp) == 0 else None
        return P(*lead, bax, _fit(d, "model", mesh))
    return P(*(None,) * nd)


def cache_shardings(cache_shape, mesh, cfg: ModelConfig,
                    seq_shard: bool = False):
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, cache_spec(
            path, tuple(leaf.shape), mesh, cfg, seq_shard)),
        cache_shape)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ------------------------------------------------------------- DTensor
def placements(named_sharding: NamedSharding, device_mesh) -> list:
    """One DTensor ``Placement`` per dim of ``device_mesh``: ``Shard(d)``
    on each mesh dim that the spec's entry for tensor dim ``d`` names,
    ``Replicate()`` on the others.

    An entry of several axes, such as ``("pod", "data")``, splits its dim
    over them major to minor, as ``jax.sharding`` does. DTensor splits a
    dim over its mesh dims in mesh-dim order, so the two agree only when
    the entry lists its axes in that order; any other order raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(named_sharding.spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} of dim {d} does not follow "
                             f"the mesh's dim order {names}")
        for m in dims:
            out[m] = Shard(d)
    return out

