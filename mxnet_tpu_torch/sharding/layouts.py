"""SpecLayout: named placement rules for the stock Gluon blocks
(counterpart of mxnet_tpu/sharding/layouts.py, whose rules and pruning it
keeps line for line).

A :class:`SpecLayout` maps each structural role a parameter can play
(embedding table, qkv/attention projection, FFN in/out matmul, norm
scale, conv filter, bias) onto the ``data``/``fsdp``/``tp`` mesh axes, so a
hybrid plan is spelled ``ShardingPlan.from_layout("dp=2,fsdp=2,tp=2",
net=net)`` (or ``MXTPU_MESH=dp=2,fsdp=2,tp=2``) instead of a regex per
weight.

Role resolution prefers STRUCTURE over names: :func:`block_roles` walks
the port's block tree (``_reg_params`` and the child modules, the prefixes
``collect_params`` builds) and classifies each parameter by its owner
block's type (``Embedding``/``Dense``/``_Conv``/norm layers) and shape (a
``Dense`` growing its feature dim is the FFN "up" projection, one
shrinking it is "down"), falling back to :func:`role_from_name` token
matching for attention projections and for env-driven plans that never
see the net.

Specs degrade safely: :meth:`SpecLayout.spec_for_role` prunes axes the
mesh doesn't carry and drops sharded axes whose product does not divide
the dimension, so an indivisible weight replicates instead of raising.
Precedence inside a plan stays ``spec_fn > regex rules > layout >
replicated``.

``zero_state_spec`` is the ZeRO companion contract: extend a param's
spec by sharding optimizer state (momenta, variances, f32 masters) along
the fsdp axis on the first unsharded divisible dim, so each position
holds 1/N of optimizer memory.

:data:`RECIPES` are the JAX package's named plans (``plan_recipe(
"dp4_tp2")``), the same axes and notes.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..parallel.mesh import PartitionSpec

__all__ = ["SpecLayout", "DEFAULT_LAYOUT", "ROLES", "block_roles",
           "role_from_name", "zero_state_spec", "RECIPES", "plan_recipe"]

#: every structural role the library knows how to place
ROLES = ("embedding", "qkv_projection", "attn_output", "ffn_up",
         "ffn_down", "norm", "conv", "bias")

# name tokens that mark a Dense as an attention projection; checked
# against the '.'-separated structured path, lowercased
_QKV_TOKENS = ("q_proj", "k_proj", "v_proj", "qkv", "query", "key",
               "value", "in_proj")
_ATTN_OUT_TOKENS = ("o_proj", "out_proj", "attn_out", "proj_out")


@dataclass(frozen=True)
class SpecLayout:
    """Role -> PartitionSpec over named ``data``/``fsdp``/``tp`` axes.

    The per-role methods return the IDEAL spec (every axis the role can
    use); :meth:`spec_for_role` prunes it against a concrete mesh and a
    concrete shape. Dense weights are ``(out_units, in_units)`` — the
    Gluon convention — so "column parallel" (split the output features,
    no collective in forward) shards dim 0 over tp and "row parallel"
    (split the contraction, psum after) shards dim 1 over tp.
    """

    data_axis: str = "dp"
    fsdp_axis: str = "fsdp"
    tp_axis: str = "tp"

    def embedding(self):
        """Vocab dim over fsdp x tp jointly; feature dim replicated."""
        return PartitionSpec((self.fsdp_axis, self.tp_axis), None)

    def qkv_projection(self):
        """Column parallel: heads split over tp, fsdp on the in dim."""
        return PartitionSpec(self.tp_axis, self.fsdp_axis)

    def attn_output(self):
        """Row parallel: the contraction splits over tp (psum after)."""
        return PartitionSpec(self.fsdp_axis, self.tp_axis)

    def ffn_up(self):
        return PartitionSpec(self.tp_axis, self.fsdp_axis)

    def ffn_down(self):
        return PartitionSpec(self.fsdp_axis, self.tp_axis)

    def norm(self):
        """1-d scale/shift/running stats: fsdp only (tiny, tp-replicated
        so every tp rank can apply them locally)."""
        return PartitionSpec(self.fsdp_axis)

    def conv(self):
        """OIHW filters: output channels over tp x fsdp, spatial whole."""
        return PartitionSpec((self.tp_axis, self.fsdp_axis), None,
                             None, None)

    def bias(self):
        """Biases replicate — sharding O(units) vectors buys nothing and
        every tp shard of the matmul output needs the full slice."""
        return PartitionSpec()

    # -- mesh/shape-aware resolution --------------------------------------
    def spec_for_role(self, role, shape=None, axis_sizes=None):
        """The role's spec pruned to a concrete mesh and shape.

        Axes the mesh doesn't carry are dropped; within one dim, sharded
        axes are then dropped right-to-left until their product divides
        the dim extent (unknown shapes skip the divisibility check — the
        mesh.shard_params divisibility error stays the backstop). A spec
        pruned down to nothing is the replicated spec.
        """
        ideal = getattr(self, role)()
        if axis_sizes is None and shape is None:
            return ideal
        entries = []
        for d, entry in enumerate(ideal):
            if entry is None:
                entries.append(None)
                continue
            axes = list(entry) if isinstance(entry, tuple) else [entry]
            if axis_sizes is not None:
                axes = [a for a in axes if a in axis_sizes]
            if shape is not None and d < len(shape) and \
                    axis_sizes is not None:
                while axes:
                    prod = 1
                    for a in axes:
                        prod *= axis_sizes[a]
                    if prod and shape[d] % prod == 0:
                        break
                    axes.pop()
            if not axes:
                entries.append(None)
            elif len(axes) == 1:
                entries.append(axes[0])
            else:
                entries.append(tuple(axes))
        while entries and entries[-1] is None:
            entries.pop()
        return PartitionSpec(*entries)

    def model_axes(self):
        """The non-batch axes this layout places over."""
        return (self.fsdp_axis, self.tp_axis)


DEFAULT_LAYOUT = SpecLayout()


def _tokens(name):
    return name.lower().replace("_", ".").split(".")


def role_from_name(name, shape=None):
    """Structural role guessed from a parameter's structured name alone
    (the env-driven path, where no block tree is in hand), or None.

    The JAX package's heuristic: attention-projection tokens, the Gluon
    spellings (gamma/beta, running statistics), conv weights by 4-d
    shape, 2-d weights by which dim is larger.
    """
    low = name.lower()
    toks = set(_tokens(name))
    leaf = name.rsplit(".", 1)[-1].lower()
    if leaf in ("gamma", "beta", "running_mean", "running_var"):
        return "norm"
    if leaf == "bias":
        return "bias"
    if "embedding" in low or "embed" in toks:
        return "embedding"
    if any(t in low for t in _QKV_TOKENS):
        return "qkv_projection"
    if any(t in low for t in _ATTN_OUT_TOKENS):
        return "attn_output"
    if leaf == "weight":
        if shape is not None and len(shape) >= 3:
            return "conv"
        if "conv" in low:
            return "conv"
        if shape is not None and len(shape) == 2:
            return "ffn_up" if shape[0] >= shape[1] else "ffn_down"
    return None


def _block_role(block, pname, param, path):
    """Role of one directly-registered param of a leaf block."""
    from ..gluon import nn as _nn

    shape = getattr(param, "shape", None)
    if isinstance(block, _nn.Embedding):
        return "embedding"
    norm_types = (_nn.BatchNorm, _nn.LayerNorm, _nn.GroupNorm,
                  _nn.InstanceNorm)
    if isinstance(block, norm_types):
        return "norm"
    if pname == "bias":
        return "bias"
    conv_base = getattr(_nn.conv_layers, "_Conv", ())
    if isinstance(block, conv_base):
        return "conv"
    if isinstance(block, _nn.Dense) and pname == "weight":
        low = path.lower()
        if any(t in low for t in _QKV_TOKENS):
            return "qkv_projection"
        if any(t in low for t in _ATTN_OUT_TOKENS):
            return "attn_output"
        if shape is not None and len(shape) == 2 and shape[1] > 0:
            return "ffn_up" if shape[0] >= shape[1] else "ffn_down"
        return "ffn_up"
    return role_from_name(path, shape)


def block_roles(net):
    """{structured param name: role} for a block tree, structure first.

    Walks the child blocks exactly as ``collect_params`` builds its
    prefixes, classifying each leaf block's own params by block TYPE
    (Embedding/Dense/Conv/norms) with the name heuristic as tiebreak for
    attention projections; params the walk can't place are omitted (the
    plan replicates them).
    """
    from ..gluon.block import Block

    roles = {}

    def walk(block, prefix):
        for pname, p in getattr(block, "_reg_params", {}).items():
            path = prefix + pname
            role = _block_role(block, pname, p, path)
            if role is not None:
                roles[path] = role
        for cname, child in block._modules.items():
            if isinstance(child, Block):
                walk(child, prefix + cname + ".")

    walk(net, "")
    return roles


def zero_state_spec(spec, shape, axis_sizes, fsdp_axis):
    """ZeRO: a state leaf's spec — the param spec extended by sharding
    along ``fsdp_axis`` on the FIRST dim that is unsharded and divisible.

    Params already fsdp-sharded (the layout's matmul weights) keep their
    spec verbatim: their state is already 1/N. Returns ``spec``
    unchanged when no dim qualifies (a scalar, or nothing divides)."""
    if fsdp_axis not in (axis_sizes or {}):
        return spec
    used = set()
    entries = list(spec)
    for entry in entries:
        for ax in (entry if isinstance(entry, tuple) else (entry,)) \
                if entry is not None else ():
            used.add(ax)
    if fsdp_axis in used:
        return spec
    n = axis_sizes[fsdp_axis]
    entries += [None] * (len(shape) - len(entries))
    for d, entry in enumerate(entries):
        if entry is None and shape[d] % n == 0 and shape[d] > 0:
            entries[d] = fsdp_axis
            return PartitionSpec(*entries)
    return spec


# -- the named plan recipes ------------------------------------------------
# The JAX package's recipes, axes, layout flags and notes verbatim: each is
# the user-facing spelling of one topology (axes + the layout + which
# companion subsystem, if any, completes it).
RECIPES = {
    "dp8": {
        "axes": "dp=-1",
        "layout": False,
        "note": "pure data parallelism; params replicate, the donated "
                "whole-step shard_map path carries the batch",
    },
    "dp4_tp2": {
        "axes": "dp=4,tp=2",
        "layout": True,
        "note": "the MULTICHIP_r05 dryrun mesh: batch over dp, matmul "
                "weights column/row-split over tp by structural role",
    },
    "dp2_fsdp2_tp2": {
        "axes": "dp=2,fsdp=2,tp=2",
        "layout": True,
        "note": "full hybrid: data x fsdp x tensor; optimizer state "
                "ZeRO-shards along fsdp (MXTPU_ZERO)",
    },
    "fsdp4": {
        "axes": "dp=2,fsdp=4",
        "layout": True,
        "note": "ZeRO-heavy: 4-way optimizer-state sharding, ~1/4 "
                "optimizer memory per device (bench opt_state_mb_per_dev)",
    },
    "ring_sp8": {
        "axes": "dp=4,tp=2",
        "layout": True,
        "companion": "parallel.ring_attention over the tp axis "
                     "(sp=ring in the r05 dryrun)",
        "note": "long-context: sequence streams around the tp ring",
    },
    "moe_ep8": {
        "axes": "dp=-1",
        "layout": False,
        "companion": "parallel.moe with experts sharded over the data "
                     "axis (ep=8 in the r05 dryrun)",
        "note": "expert parallelism; router replicates, experts shard",
    },
    "pipeline_pp8": {
        "axes": "dp=-1",
        "layout": False,
        "companion": "parallel.pipeline with 8 stages x 16 microbatches "
                     "(pp=8x16 in the r05 dryrun)",
        "note": "pipeline parallelism via the interleaved 1F1B schedule",
    },
}


def plan_recipe(name, net=None, **kw):
    """A ShardingPlan from a named recipe (:data:`RECIPES`).

    ``net`` (optional) upgrades role resolution from name tokens to the
    structural block walk. Extra kwargs pass through to the plan
    (rules=, batch_axis=, devices=...).
    """
    from .plan import ShardingPlan

    try:
        recipe = RECIPES[name]
    except KeyError:
        raise KeyError(
            f"unknown plan recipe {name!r}; have "
            f"{sorted(RECIPES)}") from None
    if recipe["layout"]:
        return ShardingPlan.from_layout(recipe["axes"], net=net, **kw)
    return ShardingPlan(recipe["axes"], **kw)
