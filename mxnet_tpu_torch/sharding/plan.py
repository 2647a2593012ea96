"""ShardingPlan: the one object that answers "where does every array live"
(counterpart of mxnet_tpu/sharding/plan.py).

A plan is (mesh axes, per-parameter PartitionSpec rules, batch axis):

    plan = ShardingPlan((("dp", -1),))                    # pure DP
    plan = ShardingPlan((("dp", 4), ("tp", 2)),
                        rules=[(r".*dense.*weight", ("tp", None))])
    plan = ShardingPlan.parse("dp=4,tp=2")                # MXTPU_MESH form
    plan = ShardingPlan("dp=4", devices=[mt.gpu(0)] * 4)  # four positions
                                                          # of one card

Construction never touches devices; :attr:`mesh` builds the port's
``parallel.mesh.Mesh`` lazily. Without ``devices`` it spans the CUDA cards
(``-1`` sizes infer from their count, a fully-specified product smaller
than it takes the leading cards) and raises without a card; ``devices=``
names the positions, which may repeat a device (``[mt.cpu()] * 8`` in
tests, ``[mt.gpu(0)] * 8`` on a one-card host). :meth:`apply` places
initialized Gluon parameters via ``parallel.mesh.shard_params`` with
:meth:`spec_for` as the spec_fn.

Spec-rule precedence, as in the JAX package:
  1. ``spec_fn(name, shape)``: a non-None return wins outright;
  2. the first matching regex in ``rules`` (searched, in order);
  3. the attached :class:`~.layouts.SpecLayout` rule library (plans built
     via :meth:`from_layout` / an MXTPU_MESH naming fsdp/tp axes):
     placement by structural role, pruned to the mesh and to divisible
     shapes;
  4. replicated (``PartitionSpec()``), so a plan with no rules is exactly
     data parallelism.

ZeRO contract: a plan whose mesh carries the layout's fsdp axis also
answers :meth:`state_spec_for`: optimizer state (momenta, variances, f32
masters) extends its param's spec by sharding along fsdp on the first
unsharded divisible dim (``layouts.zero_state_spec``), so each position
holds ~1/N of optimizer memory. ``MXTPU_ZERO=0`` turns this off.

``mode()`` is the ONE normalization of MXTPU_SHARDING:

  off   the subsystem is disabled: ``mesh=`` arguments and MXTPU_MESH
        are ignored, nothing is placed;
  auto  (default) a plan comes from explicit Trainer arguments, else
        from the MXTPU_MESH env spelling;
  plan  explicit arguments only: MXTPU_MESH is ignored.

Checkpoint contract: :meth:`to_manifest`/:meth:`from_manifest` round-trip
the plan as the JAX package's JSON record (``spec_fn`` as a flag only),
so a manifest written by either package reads in the other;
``checkpoint/snapshot.py`` stores it in every manifest and places restored
arrays under the RESTORING trainer's plan.

The JAX package also stamps the mesh into its flight recorder's identity
at :meth:`apply`; the port has no flight recorder yet (ROADMAP.md queue 1
item 11) and records the plan table (:func:`last_applied`) and the
``sharding_*`` telemetry only.
"""
from __future__ import annotations

import re

from .. import env as _env
from ..parallel.mesh import (Mesh, PartitionSpec, ShardingError, _all_cards,
                             make_mesh)
from ..parallel.mesh import shard_params as _shard_params
from ..telemetry import instruments as _telemetry

__all__ = ["ShardingPlan", "ShardingError", "mode", "parse_axes",
           "resolve_plan", "last_applied"]

_MODES = {
    "": "off", "0": "off", "off": "off", "false": "off", "no": "off",
    "none": "off",
    "1": "auto", "auto": "auto", "on": "auto", "true": "auto",
    "yes": "auto",
    "plan": "plan", "explicit": "plan",
}


def mode():
    """Resolved MXTPU_SHARDING mode: 'off' | 'auto' | 'plan'."""
    raw = str(_env.get("MXTPU_SHARDING")).strip().lower()
    try:
        return _MODES[raw]
    except KeyError:
        raise ValueError(
            f"MXTPU_SHARDING={raw!r} is not a recognized mode; expected "
            f"off | auto | plan") from None


def parse_axes(spec):
    """Normalize a mesh-axes spelling to (("name", size), ...).

    Accepts the MXTPU_MESH string form ('dp=-1', 'dp=4,tp=2'), a dict,
    or a sequence of (name, size) pairs. Sizes must be positive ints or
    -1 (infer from the device count); anything else raises ShardingError.
    """
    if isinstance(spec, str):
        pairs = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ShardingError(
                    f"mesh axis {part!r} is not 'name=size' "
                    f"(MXTPU_MESH spelling, e.g. 'dp=-1' or 'dp=4,tp=2')")
            name, _, size = part.partition("=")
            try:
                size = int(size.strip())
            except ValueError:
                raise ShardingError(
                    f"mesh axis {part!r}: size {size.strip()!r} is not "
                    f"an integer") from None
            pairs.append((name.strip(), size))
    elif isinstance(spec, dict):
        pairs = list(spec.items())
    else:
        pairs = [(str(n), int(s)) for n, s in spec]
    if not pairs:
        raise ShardingError("mesh spec names no axes")
    seen = set()
    for name, size in pairs:
        if not name:
            raise ShardingError("mesh axis with an empty name")
        if name in seen:
            raise ShardingError(f"mesh axis {name!r} appears twice")
        seen.add(name)
        if size != -1 and size < 1:
            raise ShardingError(
                f"mesh axis {name!r}: size must be a positive int or -1 "
                f"(infer), got {size}")
    return tuple((str(n), int(s)) for n, s in pairs)


def _as_spec(entry):
    """A rule's spec spelling -> PartitionSpec: already a spec, None
    (replicated), or a sequence of axis-name/None entries."""
    if entry is None:
        return PartitionSpec()
    if isinstance(entry, PartitionSpec):
        return entry
    return PartitionSpec(*entry)


# the last applied plan and its param table: observability state only
_LAST_APPLIED = [None]


def last_applied():
    """{'plan': manifest, 'mesh', 'devices', 'zero_axis', 'params': [...]}
    of the most recent :meth:`ShardingPlan.apply` in this process, or
    None."""
    return _LAST_APPLIED[0]


class ShardingPlan:
    """Mesh axes + per-parameter placement rules (module note)."""

    def __init__(self, axes, rules=None, spec_fn=None, batch_axis=None,
                 devices=None, layout=None, roles=None):
        self.axes = parse_axes(axes)
        self.rules = tuple(
            (str(pat), _as_spec(spec)) for pat, spec in (rules or ()))
        self.spec_fn = spec_fn
        # SpecLayout rule library, consulted AFTER spec_fn and the regex
        # rules; ``roles`` pins {param name: role} from a block walk
        self.layout = layout
        self.roles = dict(roles) if roles else None
        self.batch_axis = str(batch_axis) if batch_axis is not None \
            else self.axes[0][0]
        if self.batch_axis not in {n for n, _ in self.axes}:
            raise ShardingError(
                f"batch_axis {self.batch_axis!r} is not a mesh axis "
                f"(mesh has {tuple(n for n, _ in self.axes)})")
        self._devices = list(devices) if devices is not None else None
        self._mesh = None
        self._compiled_rules = [(re.compile(pat), spec)
                                for pat, spec in self.rules]

    # -- construction helpers ---------------------------------------------
    @classmethod
    def parse(cls, spec, **kw):
        """Plan from the MXTPU_MESH axis-spec string ('dp=4,tp=2')."""
        return cls(parse_axes(spec), **kw)

    @classmethod
    def from_layout(cls, axes, net=None, layout=None, **kw):
        """Plan carrying the SpecLayout rule library: stock-block params
        place by structural role over the layout's data/fsdp/tp axes.
        ``net`` upgrades role resolution from name tokens to the block
        walk; regex ``rules=`` still win on conflict."""
        from . import layouts as _layouts

        layout = layout or _layouts.DEFAULT_LAYOUT
        roles = _layouts.block_roles(net) if net is not None else None
        return cls(axes, layout=layout, roles=roles, **kw)

    @classmethod
    def from_env(cls):
        """Plan from MXTPU_MESH, or None when the env names no mesh. A
        mesh naming the layout's model axes (fsdp/tp) attaches the default
        SpecLayout (unless MXTPU_SPEC_LAYOUT=0)."""
        raw = str(_env.get("MXTPU_MESH")).strip()
        if not raw:
            return None
        axes = parse_axes(raw)
        if _env.get("MXTPU_SPEC_LAYOUT"):
            from . import layouts as _layouts

            names = {n for n, _ in axes}
            if names & set(_layouts.DEFAULT_LAYOUT.model_axes()):
                return cls.from_layout(axes)
        return cls(axes)

    @classmethod
    def from_manifest(cls, d, devices=None):
        """Inverse of :meth:`to_manifest`, for either package's record.
        The spec_fn flag comes back as None (callables don't serialize);
        rules, axes, layout and roles round-trip exactly. ``devices``
        names the positions, as in the constructor."""
        if d is None:
            return None
        layout = None
        if d.get("layout"):
            from . import layouts as _layouts

            layout = _layouts.SpecLayout(*d["layout"])
        return cls(
            tuple((str(n), int(s)) for n, s in d["axes"]),
            rules=[(pat, tuple(e if e is None else str(e) for e in spec))
                   for pat, spec in d.get("rules") or ()],
            batch_axis=d.get("batch_axis"), devices=devices,
            layout=layout, roles=d.get("roles"))

    def to_manifest(self):
        """JSON-able plan record for checkpoint manifests, the JAX
        package's keys: axes with their RESOLVED sizes once the mesh is
        built, raw sizes otherwise; the layout as its axis names; roles
        verbatim."""
        axes = self.axes if self._mesh is None else \
            tuple(self._mesh.shape.items())
        return {
            "axes": [[n, int(s)] for n, s in axes],
            "rules": [[pat, [None if e is None else str(e) for e in spec]]
                      for pat, spec in self.rules],
            "batch_axis": self.batch_axis,
            "spec_fn": self.spec_fn is not None,
            "layout": ([self.layout.data_axis, self.layout.fsdp_axis,
                        self.layout.tp_axis]
                       if self.layout is not None else None),
            "roles": self.roles,
            "zero_axis": self.zero_axis(),
        }

    # -- mesh --------------------------------------------------------------
    @property
    def mesh(self):
        """The built Mesh (lazy; -1 sizes infer from the position count)."""
        if self._mesh is None:
            devices = self._devices
            if devices is None:
                devices = _all_cards()
                product = 1
                fixed = all(s != -1 for _, s in self.axes)
                for _, s in self.axes:
                    if s != -1:
                        product *= s
                if fixed and product < len(devices):
                    devices = devices[:product]
            self._mesh = make_mesh(dict(self.axes), devices)
        return self._mesh

    def axis_sizes(self):
        """{axis: resolved size}; builds the mesh if needed."""
        return dict(self.mesh.shape)

    def process_coords(self):
        """This process's coordinates on the mesh. One process drives
        every position of a port mesh, so it sits at the origin."""
        return {ax: 0 for ax in self.mesh.axis_names}

    # -- specs -------------------------------------------------------------
    def spec_for(self, name, shape=None):
        """PartitionSpec for one parameter: spec_fn beats the first
        matching rule beats the layout library beats replicated."""
        if self.spec_fn is not None:
            spec = self.spec_fn(name, shape)
            if spec is not None:
                return _as_spec(spec)
        for pat, spec in self._compiled_rules:
            if pat.search(name):
                return spec
        if self.layout is not None:
            from . import layouts as _layouts

            role = (self.roles or {}).get(name)
            if role is None:
                role = _layouts.role_from_name(name, shape)
            if role is not None:
                return self.layout.spec_for_role(
                    role, shape, self.axis_sizes())
        return PartitionSpec()

    def data_spec(self):
        """PartitionSpec for an input batch (leading dim over the data
        axis)."""
        return PartitionSpec(self.batch_axis)

    def shards_params(self, names_shapes):
        """True when any of (name, shape) pairs resolves to a
        non-replicated spec: the tensor/FSDP case, which TrainStep runs as
        the logical step over the whole batch with the update per position
        (gluon/train_step.py), where a replicated plan runs each data
        position's shard."""
        return any(self.spec_for(n, s) != PartitionSpec()
                   for n, s in names_shapes)

    # -- ZeRO optimizer-state sharding ------------------------------------
    def zero_axis(self):
        """The mesh axis optimizer state shards along (ZeRO), or None: the
        layout's fsdp axis when the mesh carries it (the literal ``fsdp``
        for layout-less plans), gated by MXTPU_ZERO."""
        if not _env.get("MXTPU_ZERO"):
            return None
        fsdp = self.layout.fsdp_axis if self.layout is not None \
            else "fsdp"
        return fsdp if any(n == fsdp for n, _ in self.axes) else None

    def state_spec_for(self, name, shape):
        """PartitionSpec for one optimizer-state leaf mirroring param
        ``name``: the param's own spec, extended along the fsdp axis on the
        first unsharded divisible dim when ZeRO is on."""
        spec = self.spec_for(name, shape)
        axis = self.zero_axis()
        if axis is None or shape is None:
            return spec
        from . import layouts as _layouts

        return _layouts.zero_state_spec(spec, shape, self.axis_sizes(),
                                        axis)

    def shards_state(self, names_shapes):
        """True when ZeRO actually shards any state leaf beyond its
        param's own spec."""
        if self.zero_axis() is None:
            return False
        return any(self.state_spec_for(n, s) != self.spec_for(n, s)
                   for n, s in names_shapes)

    # -- application -------------------------------------------------------
    def apply(self, params, label="plan"):
        """Place initialized params per this plan (``shard_params``);
        returns the mesh. Records the plan table (:func:`last_applied`)
        and bumps ``sharding_plan_applied_total`` and the per-axis
        ``sharding_mesh_axis_size`` gauges."""
        mesh = self.mesh
        _shard_params(params, mesh, spec_fn=self.spec_for)

        def _factor(spec):
            f = 1
            for entry in spec:
                for ax in (entry if isinstance(entry, tuple)
                           else (entry,)) if entry is not None else ():
                    f *= mesh.shape[ax]
            return max(f, 1)

        table = []
        for name, p in sorted(params.items()):
            spec = self.spec_for(name, p.shape)
            sspec = self.state_spec_for(name, p.shape)
            t = p._tensor()
            nbytes = t.numel() * t.element_size()
            table.append({"param": name, "spec": str(spec),
                          "bytes_per_device": nbytes // _factor(spec),
                          "state_spec": str(sspec),
                          "state_bytes_per_device":
                              nbytes // _factor(sspec)})
        _LAST_APPLIED[0] = {"plan": self.to_manifest(),
                            "mesh": dict(mesh.shape),
                            "devices": int(mesh.devices.size),
                            "zero_axis": self.zero_axis(),
                            "params": table}
        _telemetry.record_sharding_apply(label, dict(mesh.shape),
                                         params=len(table))
        return mesh

    # -- misc --------------------------------------------------------------
    def __eq__(self, other):
        return (isinstance(other, ShardingPlan)
                and self.axes == other.axes
                and self.rules == other.rules
                and self.batch_axis == other.batch_axis
                and self.spec_fn is other.spec_fn
                and self.layout == other.layout
                and self.roles == other.roles)

    def __hash__(self):
        return hash((self.axes, self.rules, self.batch_axis,
                     self.layout))

    def __repr__(self):
        ax = ",".join(f"{n}={s}" for n, s in self.axes)
        extra = f", rules={len(self.rules)}" if self.rules else ""
        extra += ", spec_fn" if self.spec_fn is not None else ""
        extra += ", layout" if self.layout is not None else ""
        return f"ShardingPlan({ax}{extra})"


def resolve_plan(explicit=None):
    """The one plan-resolution rule Trainer uses:

      mode 'off'   -> None, always (mesh= and MXTPU_MESH both ignored);
      mode 'auto'  -> the explicit argument, else MXTPU_MESH, else None;
      mode 'plan'  -> the explicit argument only.

    ``explicit`` may be a ShardingPlan, a built Mesh (wrapped with
    replicated rules and its own axis names and positions), or any axes
    spelling parse_axes accepts.
    """
    if mode() == "off":
        return None
    plan = explicit
    if plan is not None and not isinstance(plan, ShardingPlan):
        if isinstance(plan, Mesh):
            wrapped = ShardingPlan(dict(plan.shape),
                                   devices=list(plan.devices.flat))
            wrapped._mesh = plan
            plan = wrapped
        else:
            plan = ShardingPlan(plan)
    if plan is None and mode() == "auto":
        plan = ShardingPlan.from_env()
    return plan
