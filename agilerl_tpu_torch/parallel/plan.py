"""Declarative sharding plans on ``DeviceMesh`` / DTensor: the port of
``agilerl_tpu/parallel/plan.py``.

- :class:`ShardingPlan`: a mesh axis spec (``dp`` / ``fsdp`` / ``tp`` /
  ``sp`` / ``ep`` / ``pp`` / ``pop`` sizes; ``dcn`` marks the axes that
  would cross slice boundaries), ordered ``(regex, PartitionSpec)`` rule
  groups for params / lora / optimizer / batch / KV-cache trees, and
  activation cut-point rules (:meth:`ShardingPlan.constrain`).
- :func:`match_partition_rules`: the first rule whose regex ``re.search``-
  matches the ``/``-joined leaf path and whose spec does not name more dims
  than the leaf has wins; scalars and size-1 leaves replicate; strict mode
  raises on unmatched leaves.
- A :class:`PartitionSpec` lists, per tensor dim, the mesh axes that shard
  it. On a mesh it becomes DTensor placements, one per mesh dim
  (``Shard(d)`` where an axis shards dim ``d``, else ``Replicate()``):
  :func:`spec_to_placements`. Axes that the mesh does not carry, or carries
  at size 1, drop out (:func:`parallel.mesh.filter_spec`), so one plan file
  serves every mesh down to one card.
- :meth:`ShardingPlan.zeros` allocates a tree (the serving tier's KV caches
  by the ``kv`` / ``kv_paged`` groups) as DTensors of zeros, each rank only
  its own shard (:func:`local_shape`), with a dim that its axes do not
  divide left whole (:func:`tiling_placements`).
- :func:`compile_step_with_plan` returns a :class:`PlanCompiledStep` that
  places each argument by its group (``redistribute`` of a DTensor) and runs
  the step eagerly. ``.lower`` and ``cache=`` raise ``NotImplementedError``:
  the port has no ahead-of-time compile.

Plans serialise to and from the YAML files of ``configs/sharding/`` and
register in a process-wide registry that the sharding mutation draws from.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from agilerl_tpu_torch.parallel.tree_paths import named_tree_map

PyTree = Any

#: canonical mesh-axis order: plans list sizes in this order so two plans
#: with the same axes always build identically shaped meshes
AXIS_ORDER = ("dp", "fsdp", "tp", "sp", "ep", "pp", "pop")


class PartitionSpec(tuple):
    """Per tensor dim: None, one axis name, or a tuple of axis names (the
    ``jax.sharding.PartitionSpec`` entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


P = PartitionSpec
Rule = Tuple[str, PartitionSpec]


class UnmatchedLeafError(ValueError):
    """Strict-mode rule resolution found leaves no rule matches."""


class AbstractLeaf(NamedTuple):
    """A leaf's shape, dtype and rule-resolved placements (what
    ``jax.ShapeDtypeStruct`` with a sharding carries)."""

    shape: Tuple[int, ...]
    dtype: Any
    placements: Optional[Tuple[Any, ...]] = None


def _is_spec(x: Any) -> bool:
    return isinstance(x, PartitionSpec)


def _shape(leaf: Any) -> Tuple[int, ...]:
    shape = getattr(leaf, "shape", None)
    return tuple(shape) if shape is not None else tuple(np.shape(leaf))


# --------------------------------------------------------------------------- #
# The rule matcher
# --------------------------------------------------------------------------- #


def _spec_fits(spec: PartitionSpec, leaf: Any) -> bool:
    """A rule applies only when its spec names no more dims than the leaf
    has: one ordered list carries the 3-D stacked-expert and the 2-D dense
    variants of a weight name."""
    return len(spec) <= len(_shape(leaf))


def match_partition_rules(rules: Sequence[Rule], tree: PyTree, *, strict: bool = False,
                          on_unmatched: Optional[Callable[[str, Any], None]] = None) -> PyTree:
    """A tree of :class:`PartitionSpec` from ordered regex rules: scalar and
    size-1 leaves take ``P()``; the first rule that matches the path and fits
    the rank wins; unmatched leaves raise :class:`UnmatchedLeafError` in
    strict mode (listing every offender), else replicate after
    ``on_unmatched(path, leaf)``."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    unmatched: List[str] = []

    def get_spec(name: str, leaf: Any) -> PartitionSpec:
        shape = _shape(leaf)
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return P()
        for pat, spec in compiled:
            if pat.search(name) is not None and _spec_fits(spec, leaf):
                return spec
        if strict:
            unmatched.append(f"{name} {shape}")
        elif on_unmatched is not None:
            on_unmatched(name, leaf)
        return P()

    out = named_tree_map(get_spec, tree, sep="/")
    if unmatched:
        raise UnmatchedLeafError(
            f"no partition rule matched {len(unmatched)} leaves: {unmatched[:8]}"
            + (" ..." if len(unmatched) > 8 else "")
            + " — add a rule (a catch-all ['.*', []] replicates) or resolve with strict=False")
    return out


# --------------------------------------------------------------------------- #
# PartitionSpec <-> YAML entries <-> DTensor placements
# --------------------------------------------------------------------------- #


def spec_to_entries(spec: PartitionSpec) -> List[Any]:
    """``P(("dp", "fsdp"), None, "tp")`` -> ``[["dp", "fsdp"], None, "tp"]``."""
    return [None if e is None else list(e) if isinstance(e, (tuple, list)) else str(e)
            for e in spec]


def entries_to_spec(entries: Sequence[Any]) -> PartitionSpec:
    return P(*(None if e is None else tuple(str(a) for a in e) if isinstance(e, (tuple, list))
               else str(e) for e in entries))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, in its dim order."""
    return {str(n): int(s) for n, s in zip(mesh.mesh_dim_names, mesh.shape)}


def spec_to_placements(spec: PartitionSpec, mesh) -> Tuple[Any, ...]:
    """One DTensor placement per mesh dim: ``Shard(d)`` where the spec names
    that axis for tensor dim ``d``, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of: Dict[str, int] = {}
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in mesh.mesh_dim_names)


def tiling_placements(spec: PartitionSpec, shape: Sequence[int], mesh) -> Tuple[Any, ...]:
    """``spec_to_placements`` with every dim whose axes do not divide its
    size left whole (GSPMD would pad it): a one-row prefill cache keeps its
    row on every data rank, and no local shard is ever ragged."""
    sizes = mesh_axis_sizes(mesh)
    entries = []
    for d, e in enumerate(spec):
        n = math.prod(sizes.get(a, 1) for a in ((e,) if isinstance(e, str) else (e or ())))
        entries.append(e if d < len(shape) and shape[d] % n == 0 else None)
    return spec_to_placements(P(*entries), mesh)


#: the GPT stack's attention projections, their biases and the LoRA adapters
#: on them (and, by their paths, the adapters' optimizer states)
_HEAD_LEAF = re.compile(r"(^|/)(w[qkvo]|b[qkv])(/[AB])?$")


def heads_tile(heads: Sequence[int], mesh) -> bool:
    """Whether the mesh's tp axis divides every head count in ``heads``
    (query heads, KV heads): a tp split of attention must keep whole heads
    (and whole GQA groups) on each rank."""
    tp = mesh_axis_sizes(mesh).get("tp", 1)
    return all(h % tp == 0 for h in heads)


def _without_tp(spec: PartitionSpec) -> PartitionSpec:
    def drop(e):
        if isinstance(e, str):
            return None if e == "tp" else e
        if e:
            kept = tuple(a for a in e if a != "tp")
            return kept or None
        return e

    return P(*(drop(e) for e in spec))


def local_shape(shape: Sequence[int], placements, mesh) -> Tuple[int, ...]:
    """This rank's shard shape of a tensor of ``shape`` whose dims the
    ``placements`` (one per mesh dim) tile evenly."""
    out = list(shape)
    for md, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= mesh.shape[md]
    return tuple(out)


def place_tensor(x: torch.Tensor, mesh, placements) -> Any:
    """``device_put``: ``x`` as a DTensor on ``mesh`` with ``placements``. A
    DTensor on the same mesh is redistributed; a plain tensor is taken as
    the same full value on every rank, so each rank keeps its shard of its
    own copy and nothing is sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = tuple(placements)
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            if tuple(x.placements) == placements:
                return x
            return x.redistribute(mesh, placements)
        x = x.full_tensor()
    return distribute_tensor(x.detach() if not x.requires_grad else x, mesh, placements,
                             src_data_rank=None)


# --------------------------------------------------------------------------- #
# ShardingPlan
# --------------------------------------------------------------------------- #


@dataclass
class ShardingPlan:
    """One declarative layout: mesh axes + ordered rule groups.

    ``axes`` maps axis name -> size (canonical order :data:`AXIS_ORDER`;
    other names follow in the given order). ``dcn`` marks axes that cross
    slice boundaries; the port keeps it as a record of the layout (its mesh
    is one ``DeviceMesh`` either way). ``rules`` maps a group name to its
    ordered rule list; ``activations`` holds the cut-point rules of
    :meth:`constrain`."""

    name: str
    axes: Dict[str, int]
    rules: Dict[str, List[Rule]] = field(default_factory=dict)
    activations: List[Rule] = field(default_factory=list)
    dcn: Dict[str, int] = field(default_factory=dict)
    strict: bool = False
    description: str = ""

    # -- mesh ---------------------------------------------------------------- #
    @property
    def device_count(self) -> int:
        n = 1
        for size in self.axes.values():
            n *= int(size)
        return n

    def ordered_axes(self) -> List[Tuple[str, int]]:
        known = [(a, int(self.axes[a])) for a in AXIS_ORDER if a in self.axes]
        extra = [(a, int(s)) for a, s in self.axes.items() if a not in AXIS_ORDER]
        return known + extra

    def build_mesh(self, device: Any = None):
        """The plan's ``DeviceMesh`` over the process group's ranks (one card
        per rank; ``device=None`` is the card, ``"cpu"`` the gloo ranks of
        the tests). The group's world size must equal ``device_count``.

        The mesh carries the axes of size > 1, in canonical order (or, when
        every axis has size 1, all of them): a size-1 axis shards nothing
        (``filter_spec`` drops it from every spec), and each mesh dim
        multiplies the placement strategies DTensor weighs per operation."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from agilerl_tpu_torch.ops import resolve_device

        dev = resolve_device(device)
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world != self.device_count:
            raise ValueError(
                f"plan {self.name!r} needs {self.device_count} devices "
                f"({dict(self.ordered_axes())}), the process group has {world}")
        if not dist.is_initialized():
            raise RuntimeError(
                "build_mesh needs an initialised process group "
                "(torch.distributed.init_process_group), even at world size 1")
        axes = [(a, s) for a, s in self.ordered_axes() if s > 1] or self.ordered_axes()
        return init_device_mesh(dev.type, tuple(s for _, s in axes),
                                mesh_dim_names=tuple(a for a, _ in axes))

    # -- rule resolution ------------------------------------------------------ #
    def group_rules(self, group: str) -> List[Rule]:
        if group not in self.rules:
            raise KeyError(f"plan {self.name!r} has no rule group {group!r}; "
                           f"available: {sorted(self.rules)}")
        return self.rules[group]

    def resolve(self, group: str, tree: PyTree, mesh=None,
                strict: Optional[bool] = None,
                heads: Optional[Sequence[int]] = None) -> PyTree:
        """A tree of PartitionSpec for ``tree`` under ``group``'s rules; with
        ``mesh``, axes the mesh does not carry (or carries at size 1) drop.

        ``heads`` (the model's query and KV head counts) decides the tp
        split of attention by whole heads: where the mesh's tp does not
        divide them (:func:`heads_tile`), the attention projections, their
        biases and adapters (and the adapters' optimizer states) keep their
        head axis whole over tp, so attention runs replicated over tp while
        the MLP stays tp-parallel. GSPMD pads such a split instead; a
        DTensor view of an unevenly sharded head axis raises."""
        strict = self.strict if strict is None else strict
        on_unmatched = None
        if not strict:
            from agilerl_tpu_torch.observability.registry import warn_once

            def on_unmatched(path, leaf):
                warn_once(f"sharding_plan/{self.name}/{group}/unmatched",
                          f"sharding plan {self.name!r} group {group!r}: no rule matched "
                          f"leaf {path!r} (replicating; first occurrence only)")

        specs = match_partition_rules(self.group_rules(group), tree, strict=strict,
                                      on_unmatched=on_unmatched)
        if mesh is not None:
            from agilerl_tpu_torch.parallel.mesh import filter_spec

            specs = named_tree_map(lambda _n, s: filter_spec(s, mesh), specs, is_leaf=_is_spec)
            if heads is not None and not heads_tile(heads, mesh):
                specs = named_tree_map(
                    lambda n, s: _without_tp(s) if _HEAD_LEAF.search(n) else s, specs,
                    is_leaf=_is_spec)
        return specs

    def shardings(self, group: str, tree: PyTree, mesh, strict: Optional[bool] = None) -> PyTree:
        """A tree of DTensor placement tuples (one placement per mesh dim)."""
        return named_tree_map(lambda _n, s: spec_to_placements(s, mesh),
                              self.resolve(group, tree, mesh, strict=strict), is_leaf=_is_spec)

    def place(self, group: str, tree: PyTree, mesh, strict: Optional[bool] = None,
              heads: Optional[Sequence[int]] = None) -> PyTree:
        """Every tensor leaf as a DTensor with its rule-resolved placements
        (``heads``: see :meth:`resolve`); other leaves (step counts,
        hyperparameters) are kept."""
        specs = self.resolve(group, tree, mesh, strict=strict, heads=heads)

        def put(_name, leaf, spec):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            return place_tensor(leaf, mesh, spec_to_placements(spec, mesh))

        return named_tree_map(put, tree, specs)

    def zeros(self, group: str, tree: PyTree, mesh, device: Any = None) -> PyTree:
        """``tree``'s tensor leaves (their shapes and dtypes: the ``"meta"``
        device will do) as DTensors of zeros on ``mesh``, by ``group``'s rules
        where the axes tile the dim (:func:`tiling_placements`). Each rank
        allocates only its own shard; other leaves are kept. The serving
        tier's KV caches and pools (the ``kv`` / ``kv_paged`` groups)."""
        from torch.distributed.tensor import DTensor

        from agilerl_tpu_torch.ops import resolve_device

        dev = resolve_device(device)
        specs = self.resolve(group, tree, mesh)

        def put(_name, leaf, spec):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            pl = tiling_placements(spec, leaf.shape, mesh)
            local = torch.zeros(local_shape(leaf.shape, pl, mesh), dtype=leaf.dtype, device=dev)
            return DTensor.from_local(local, mesh, pl, run_check=False, shape=leaf.shape,
                                      stride=torch.empty(leaf.shape, device="meta").stride())

        return named_tree_map(put, tree, specs)

    def abstract(self, group: str, tree: PyTree, mesh, strict: Optional[bool] = None) -> PyTree:
        """:class:`AbstractLeaf` tree carrying the rule-resolved placements."""
        specs = self.resolve(group, tree, mesh, strict=strict)
        return named_tree_map(
            lambda _n, leaf, spec: AbstractLeaf(_shape(leaf), getattr(leaf, "dtype", None),
                                                spec_to_placements(spec, mesh)),
            tree, specs)

    def constrain(self, x: torch.Tensor, name: str, mesh=None) -> torch.Tensor:
        """Activation cut-point (``with_sharding_constraint``): the first
        matching ``activations`` rule's placements, by ``redistribute`` of a
        DTensor (on its own mesh) or placement of a plain tensor on ``mesh``.
        A plain tensor without a mesh, or no matching rule, passes through."""
        from torch.distributed.tensor import DTensor

        for pat, spec in self.activations:
            if re.search(pat, name) is not None and _spec_fits(spec, x):
                m = x.device_mesh if isinstance(x, DTensor) else mesh
                if m is None:
                    return x
                from agilerl_tpu_torch.parallel.mesh import filter_spec

                return place_tensor(x, m, spec_to_placements(filter_spec(spec, m), m))
        return x

    # -- (de)serialisation ---------------------------------------------------- #
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"name": self.name,
                             "mesh": {a: int(s) for a, s in self.ordered_axes()}}
        if self.description:
            d["description"] = self.description
        if self.dcn:
            d["dcn"] = {a: int(s) for a, s in self.dcn.items()}
        if self.strict:
            d["strict"] = True
        d["rules"] = {g: [[pat, spec_to_entries(spec)] for pat, spec in rl]
                      for g, rl in self.rules.items()}
        if self.activations:
            d["activations"] = [[pat, spec_to_entries(spec)] for pat, spec in self.activations]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ShardingPlan":
        rules = {g: [(str(pat), entries_to_spec(entries)) for pat, entries in rl]
                 for g, rl in (d.get("rules") or {}).items()}
        activations = [(str(pat), entries_to_spec(entries))
                       for pat, entries in (d.get("activations") or [])]
        return cls(name=str(d["name"]),
                   axes={str(a): int(s) for a, s in (d.get("mesh") or {}).items()},
                   rules=rules, activations=activations,
                   dcn={str(a): int(s) for a, s in (d.get("dcn") or {}).items()},
                   strict=bool(d.get("strict", False)),
                   description=str(d.get("description", "")))

    def to_yaml(self, path: str) -> None:
        """Atomic write: a torn half-plan is never loadable."""
        import yaml

        from agilerl_tpu_torch.resilience.atomic import atomic_write_bytes

        atomic_write_bytes(path, yaml.safe_dump(self.to_dict(), sort_keys=False).encode("utf-8"))

    @classmethod
    def from_yaml(cls, path: str) -> "ShardingPlan":
        import yaml

        with open(path) as fh:
            return cls.from_dict(yaml.safe_load(fh) or {})

    def with_axes(self, name: Optional[str] = None, **axes: int) -> "ShardingPlan":
        """Same rules, another mesh shape."""
        new_axes = dict(self.axes)
        new_axes.update({a: int(s) for a, s in axes.items()})
        return ShardingPlan(name=name or self.name, axes=new_axes,
                            rules={g: list(r) for g, r in self.rules.items()},
                            activations=list(self.activations), dcn=dict(self.dcn),
                            strict=self.strict, description=self.description)


# --------------------------------------------------------------------------- #
# Built-in rule sets
# --------------------------------------------------------------------------- #


def gpt_param_rules() -> List[Rule]:
    """Megatron-style tp + an fsdp second axis for the GPT stack; MoE (3-D
    stacked-expert) weights hit the ``ep`` rules first, dense (2-D) weights
    skip them by the rank guard."""
    return [
        (r"(^|/)ln(1|2|_f)$", P()),
        (r"(^|/)b[qkv]$", P("tp")),
        (r"(^|/)router$", P()),
        (r"(^|/)w[qkv]$", P("fsdp", "tp")),
        (r"(^|/)wo$", P("tp", "fsdp")),
        (r"(^|/)w_(gate|up)$", P("ep", "fsdp", "tp")),
        (r"(^|/)w_(gate|up)$", P("fsdp", "tp")),
        (r"(^|/)w_down$", P("ep", "tp", "fsdp")),
        (r"(^|/)w_down$", P("tp", "fsdp")),
        (r"(^|/)tok_emb$", P("tp", "fsdp")),
        (r"(^|/)lm_head$", P("fsdp", "tp")),
    ]


def lora_rules() -> List[Rule]:
    """LoRA adapters: A row-sharded on fsdp, B column-sharded on tp."""
    return [(r"(^|/)A$", P("fsdp", None)), (r"(^|/)B$", P(None, "tp")), (r".*", P())]


def optimizer_rules(param_rules: Optional[List[Rule]] = None) -> List[Rule]:
    """Optimizer states: their paths embed the param path, so the param
    group's rules match as they are; scalars replicate."""
    return list(param_rules if param_rules is not None else lora_rules())


def batch_rules() -> List[Rule]:
    """Training batches: every leaf's rows shard over (dp, fsdp)."""
    return [(r".*", P(("dp", "fsdp")))]


def kv_cache_rules() -> List[Rule]:
    """Dense KV cache (``k`` / ``v`` ``[L, B, S, KV, hd]``): batch over
    (dp, fsdp), kv heads over tp; the ``mask`` ``[B, S]`` over batch."""
    return [(r"(^|/)(k|v)$", P(None, ("dp", "fsdp"), None, "tp", None)),
            (r"(^|/)mask$", P(("dp", "fsdp"))),
            (r".*", P())]


def paged_kv_rules() -> List[Rule]:
    """Paged KV pool (``[L, n_blocks, bs, KV, hd]``): axis 1 holds global
    block ids and never shards; kv heads over tp."""
    return [(r"(^|/)(k|v)$", P(None, None, None, "tp", None)), (r".*", P())]


def member_rules(axis: str = "pop") -> List[Rule]:
    """Population layout: every member-stacked leaf's leading axis over ``axis``."""
    return [(r".*", P(axis))]


def grpo_activation_rules() -> List[Rule]:
    """Cut-points of the GRPO step: hidden and logit activations pin batch
    over (dp, fsdp)."""
    return [(r"(^|/)(hidden|residual)$", P(("dp", "fsdp"), None, "tp")),
            (r"(^|/)(logits|logprobs|lp)$", P(("dp", "fsdp"))),
            (r".*", P(("dp", "fsdp")))]


def _grpo_rules() -> Dict[str, List[Rule]]:
    return {"params": gpt_param_rules(), "lora": lora_rules(), "optimizer": optimizer_rules(),
            "batch": batch_rules(), "kv": kv_cache_rules(), "kv_paged": paged_kv_rules()}


def make_grpo_plan(name: Optional[str] = None, dp: int = 1, fsdp: int = 1, tp: int = 1,
                   ep: int = 1, dcn_dp: int = 1, strict: bool = False,
                   description: str = "") -> ShardingPlan:
    """The built-in GRPO rule set on a (dp, fsdp, tp[, ep]) mesh."""
    axes = {"dp": int(dp), "fsdp": int(fsdp), "tp": int(tp)}
    if ep > 1:
        axes["ep"] = int(ep)
    mesh_name = "x".join(f"{a}{s}" for a, s in axes.items() if s > 1) or "dp1"
    return ShardingPlan(name=name or f"grpo-{mesh_name}", axes=axes, rules=_grpo_rules(),
                        activations=grpo_activation_rules(),
                        dcn={"dp": int(dcn_dp)} if dcn_dp > 1 else {},
                        strict=strict, description=description)


def resolve_plan_and_mesh(plan: Optional[Union[ShardingPlan, str]], mesh=None,
                          device: Any = None) -> Tuple[Optional[ShardingPlan], Any]:
    """Normalise the (plan, mesh) pair every consumer accepts: a plan name
    resolves through the registry, and a plan without a mesh builds its
    own. ``(None, mesh)`` passes through."""
    if plan is None:
        return None, mesh
    if isinstance(plan, str):
        plan = get_plan(plan)
    if mesh is None:
        mesh = plan.build_mesh(device)
    return plan, mesh


def place_by_shape(tree: PyTree, template: PyTree, template_specs: PyTree, mesh) -> PyTree:
    """Shape-keyed placement: every leaf of ``tree`` whose shape matches a
    template leaf takes that leaf's spec, everything else replicates."""
    shapes_to_spec: Dict[Any, PartitionSpec] = {}
    named_tree_map(lambda _n, leaf, spec: shapes_to_spec.setdefault(_shape(leaf), spec),
                   template, template_specs)

    def put(_name, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        spec = shapes_to_spec.get(_shape(leaf), P())
        return place_tensor(leaf, mesh, spec_to_placements(spec, mesh))

    return named_tree_map(put, tree)


def grpo_plan_for_mesh(mesh) -> ShardingPlan:
    """The built-in GRPO rule set shaped to an existing mesh; axes the rules
    do not name (``sp``, ``pop``) ride along and shard nothing."""
    shape = mesh_axis_sizes(mesh)
    return ShardingPlan(name="grpo-" + "x".join(f"{a}{s}" for a, s in shape.items()),
                        axes=dict(shape), rules=_grpo_rules(),
                        activations=grpo_activation_rules())


def make_population_plan(pop: int, name: Optional[str] = None, axis: str = "pop") -> ShardingPlan:
    """Pod population layout: members shard over the ``pop`` axis; the
    ``member`` group is what ``make_pod_generation`` resolves."""
    return ShardingPlan(name=name or f"population-{axis}{pop}", axes={axis: int(pop)},
                        rules={"member": member_rules(axis)})


# --------------------------------------------------------------------------- #
# Plan registry (what the sharding mutation draws from)
# --------------------------------------------------------------------------- #

_REGISTRY: Dict[str, ShardingPlan] = {}


def register_plan(plan: ShardingPlan, overwrite: bool = False) -> ShardingPlan:
    if plan.name in _REGISTRY and not overwrite:
        raise ValueError(f"sharding plan {plan.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[plan.name] = plan
    return plan


def get_plan(name: str) -> ShardingPlan:
    if name not in _REGISTRY:
        raise KeyError(f"unknown sharding plan {name!r}; registered: {registered_plans()}")
    return _REGISTRY[name]


def registered_plans() -> List[str]:
    return sorted(_REGISTRY)


def clear_registry() -> None:
    """Empty the process-wide registry (tests isolate it with this)."""
    _REGISTRY.clear()


def live_device_count() -> int:
    """The process group's world size (one card per rank), 1 without one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def plans_for_device_count(n: int) -> List[ShardingPlan]:
    """Registered plans whose mesh exactly fills ``n`` devices."""
    return [p for p in _REGISTRY.values() if p.device_count == int(n)]


def default_grpo_plans(n_devices: int) -> List[ShardingPlan]:
    """Pure fsdp plus every fsdp x tp split with tp a power of two <= 8."""
    plans = []
    tp = 1
    while tp <= min(8, n_devices):
        if n_devices % tp == 0:
            plans.append(make_grpo_plan(fsdp=n_devices // tp, tp=tp))
        tp *= 2
    return plans


def register_default_plans(n_devices: Optional[int] = None) -> List[str]:
    """Idempotently register the default GRPO layouts for ``n_devices``
    (default: the live device count). Returns the registered names."""
    n = int(n_devices) if n_devices is not None else live_device_count()
    names = []
    for plan in default_grpo_plans(n):
        if plan.name not in _REGISTRY:
            register_plan(plan)
        names.append(plan.name)
    return names


def load_plan(path: str, register: bool = True) -> ShardingPlan:
    """Load a YAML plan and, by default, register it (idempotent by name)."""
    plan = ShardingPlan.from_yaml(path)
    if register:
        register_plan(plan, overwrite=True)
    return plan


# --------------------------------------------------------------------------- #
# compile_step_with_plan: the eager counterpart
# --------------------------------------------------------------------------- #

_NO_AOT = ("{} is not ported: the port runs its steps eagerly and has no "
           "ahead-of-time compile or executable store")


class PlanCompiledStep:
    """A step under a plan: calling it places each argument named in
    ``in_groups`` by its group (``constrain_inputs``) and runs the step under
    ``implicit_replication`` (plain tensors beside DTensors count as
    replicated). ``abstract_args`` / ``place_args`` give the rule-resolved
    descriptions and placements; ``lower`` and ``load_or_compile`` raise."""

    def __init__(self, step_fn: Callable, plan: ShardingPlan, mesh,
                 in_groups: Sequence[Optional[str]], *, constrain_inputs: bool = True,
                 name: Optional[str] = None):
        self.step_fn = step_fn
        self.plan = plan
        self.mesh = mesh
        self.in_groups = tuple(in_groups)
        self.constrain_inputs = bool(constrain_inputs)
        self.name = name or f"plan_step/{plan.name}/{getattr(step_fn, '__name__', 'step')}"
        self.cache = None

    def __call__(self, *args, **kwargs):
        from torch.distributed.tensor.experimental import implicit_replication

        if self.constrain_inputs:
            args = self.place_args(*args) + tuple(args[len(self.in_groups):])
        with implicit_replication():
            return self.step_fn(*args, **kwargs)

    def lower(self, *args, **kwargs):
        raise NotImplementedError(_NO_AOT.format("PlanCompiledStep.lower"))

    def load_or_compile(self, *args, **kwargs):
        raise NotImplementedError(_NO_AOT.format("PlanCompiledStep.load_or_compile"))

    @property
    def cache_info(self):
        return None

    def abstract_args(self, *args):
        """Rule-resolved :class:`AbstractLeaf` trees for ``args``, per group."""
        out = []
        for group, arg in zip(self.in_groups, args):
            if group is None:
                out.append(named_tree_map(
                    lambda _n, leaf: AbstractLeaf(_shape(leaf), getattr(leaf, "dtype", None)),
                    arg))
            else:
                out.append(self.plan.abstract(group, arg, self.mesh))
        return tuple(out)

    def place_args(self, *args):
        """Place concrete argument trees with their rule-resolved placements."""
        return tuple(arg if group is None else self.plan.place(group, arg, self.mesh)
                     for group, arg in zip(self.in_groups, args))


def compile_step_with_plan(step_fn: Callable, plan: Union[ShardingPlan, str],
                           in_groups: Sequence[Optional[str]], *, mesh=None, device: Any = None,
                           constrain_inputs: bool = True, cache=None,
                           name: Optional[str] = None) -> PlanCompiledStep:
    """``step_fn`` under ``plan``: each positional argument named in
    ``in_groups`` (a rule group, or None to leave it) is placed by its
    group on entry; the step runs eagerly on the placed DTensors. ``cache``
    (the JAX package's executable store) raises ``NotImplementedError``."""
    if cache is not None and cache is not False:
        raise NotImplementedError(_NO_AOT.format("compile_step_with_plan(cache=)"))
    if isinstance(plan, str):
        plan = get_plan(plan)
    mesh = mesh if mesh is not None else plan.build_mesh(device)
    return PlanCompiledStep(step_fn, plan, mesh, in_groups, constrain_inputs=constrain_inputs,
                            name=name)
