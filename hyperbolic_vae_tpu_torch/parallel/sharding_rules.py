"""Parameter layouts: tensor parallelism and FSDP over a (data, model) mesh.

Port of ``hyperbolic_vae_tpu/parallel/sharding_rules.py``. A layout maps
every ``state_dict`` key of a model to a spec: for each dimension of the
torch tensor, the mesh axis that splits it, or None (JAX's
``PartitionSpec``, in torch's dimension order). The Trainer applies it
(``Trainer(param_sharding_fn=...)``; ``parallel/tensor_parallel.py``,
``parallel/fsdp.py``):

  * ``tp_param_shardings``: JAX's name rules, on the layers a model
    declares in ``tp_roles`` (the four dense families: GyroplaneVAE,
    RNASeqVAE, UnifiedVAE, PvaeMLPVAE): an encoder Linear (flax
    ``enc*``) splits its output rows and its bias over 'model'; the
    gyroplanes (``mp_points``, and their bias) split their planes over
    'model', so each model rank launches the gyroplane kernel on its
    planes; the decoder's output Linear (``dec_out``) splits its
    contraction (input) columns. Every other key is replicated.
  * ``fsdp_param_shardings``: every leaf of at least
    ``FSDP_MIN_LEAF_ELEMS`` elements split over 'data' along its largest
    axis that the data axis divides; the rest replicated.
  * ``fsdp_tp_param_shardings``: the TP rules, then the largest free
    divisible axis of every big leaf over 'data'.
  * ``opt_state_shardings``: the optimizer's moments (and EMA) take their
    parameter's spec; the step count and lr stay replicated.

JAX decides on flax's parameters, whose Dense kernels are (in, out) and
conv kernels (kh, kw, in, out); the port's Linear weights are (out, in),
its conv weights (out, in, kh, kw) and its transposed-conv weights (in,
out, kh, kw). So each rule works in flax's axis order (``flax_axes``)
and writes its spec in torch's: the TP rule's P(None, 'model') on an
encoder kernel is dimension 0 of the port's weight, and FSDP's tie-break
between equal axes, ``max((size, axis))``, runs over flax's axes, so a
square weight splits where JAX splits it. A dimension that its axis does
not divide is refused, naming the key and the sizes, as JAX's
``device_put`` refuses an uneven ``NamedSharding``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from hyperbolic_vae_tpu_torch.nn import PoincareHyperplanes
from hyperbolic_vae_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

# Below this many elements a leaf is replicated (JAX's bound): gathering a
# small bias costs more than its shard saves.
FSDP_MIN_LEAF_ELEMS = 8192

# JAX's _spec_for by role (the flax name its rule matches): the layer type
# that plays it and the spec of each of that layer's tensors, in torch's
# dimension order; an unnamed tensor (dec_out's bias) is replicated
_ROLES = {
    "enc": (nn.Linear, {"weight": (MODEL_AXIS, None), "bias": (MODEL_AXIS,)}),
    "gyroplanes": (PoincareHyperplanes, {"points": (MODEL_AXIS, None), "bias": (MODEL_AXIS,)}),
    "dec_out": (nn.Linear, {"weight": (None, MODEL_AXIS)}),
}

Spec = Tuple[Optional[str], ...]


def _owners(model) -> Dict[str, Tuple[str, nn.Module]]:
    """state_dict key -> (the attribute's name, its module)."""
    out = {}
    for mname, mod in model.named_modules():
        for name, _ in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            out[f"{mname}.{name}" if mname else name] = (name, mod)
    return out


def flax_axes(module: nn.Module, name: str, ndim: int) -> Tuple[int, ...]:
    """``order[a]``: the torch dimension of flax's axis ``a`` for the
    tensor ``name`` of ``module`` (a Linear weight (out, in) is flax's
    (in, out); a conv weight (out, in, kh, kw) flax's (kh, kw, in, out); a
    transposed conv's (in, out, kh, kw) the same flax kernel). Every other
    tensor keeps flax's order."""
    if name == "weight" and isinstance(module, nn.Linear):
        return (1, 0)
    if name == "weight" and isinstance(module, nn.ConvTranspose2d):
        return (2, 3, 0, 1)
    if name == "weight" and isinstance(module, nn.Conv2d):
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def _tp_roles(model) -> Dict[str, Spec]:
    """JAX's ``_spec_for`` on the port's keys: key -> torch spec, for the
    keys it shards. The model declares which of its layers play JAX's
    roles (``tp_roles``: module path -> role, over every layer of the
    role's type at or under the path), as flax's names declare them."""
    declared = getattr(model, "tp_roles", None)
    if not declared:
        raise ValueError(f"{type(model).__name__} declares no tensor-parallel roles (tp_roles: "
                         f"the layers JAX's rules name {', '.join(_ROLES)}); it trains data "
                         f"parallel or under fsdp_param_shardings")
    modules = dict(model.named_modules())
    roles: Dict[str, Spec] = {}
    for path, role in declared.items():
        if role not in _ROLES or path not in modules:
            raise ValueError(f"{type(model).__name__}.tp_roles: {path!r} -> {role!r} names no "
                             f"layer of the model or no role of {sorted(_ROLES)}")
        kind, specs = _ROLES[role]  # as JAX's rules, a role may match no layer
        for name, mod in modules[path].named_modules():
            if isinstance(mod, kind):
                mname = f"{path}.{name}" if name else path
                roles.update({f"{mname}.{t}": spec for t, spec in specs.items()})
    return roles


def _checked(key: str, t: torch.Tensor, spec: Spec, mesh) -> Spec:
    for d, axis in enumerate(spec):
        if axis is not None and t.shape[d] % mesh.shape[axis]:
            raise ValueError(f"{key}: dimension {d} of size {t.shape[d]} does not split evenly "
                             f"over the {mesh.shape[axis]} ranks of the {axis!r} axis "
                             f"(shape {tuple(t.shape)})")
    return spec


def _fsdp_axis(shape, taken, n: int) -> Optional[int]:
    """Largest axis divisible by n and not already taken (ties: the later
    axis, as ``max((d, i))``); None if none."""
    free = [(d, i) for i, d in enumerate(shape) if i not in taken and d % n == 0]
    return max(free)[1] if free else None


def _layout(model, mesh, tp: bool, fsdp: bool, min_leaf_elems: int) -> Dict[str, Spec]:
    roles = _tp_roles(model) if tp else {}
    owners = _owners(model)
    n = mesh.shape[DATA_AXIS]
    out = {}
    for key, t in model.state_dict().items():
        spec = list(roles.get(key, ())) + [None] * (t.dim() - len(roles.get(key, ())))
        if fsdp and n > 1 and t.numel() >= min_leaf_elems:
            name, mod = owners[key]
            order = flax_axes(mod, name, t.dim())
            fshape = [t.shape[d] for d in order]
            taken = tuple(a for a, d in enumerate(order) if spec[d] is not None)
            ax = _fsdp_axis(fshape, taken, n)
            if ax is not None:
                spec[order[ax]] = DATA_AXIS
        out[key] = _checked(key, t, tuple(spec), mesh)
    return out


def tp_param_shardings(model, mesh) -> Dict[str, Spec]:
    """Tensor parallelism over 'model' (the module docstring's rules); for
    ``Trainer(param_sharding_fn=tp_param_shardings)``."""
    return _layout(model, mesh, tp=True, fsdp=False, min_leaf_elems=FSDP_MIN_LEAF_ELEMS)


def fsdp_param_shardings(model, mesh, min_leaf_elems: int = FSDP_MIN_LEAF_ELEMS
                         ) -> Dict[str, Spec]:
    """Every leaf of at least ``min_leaf_elems`` elements split over 'data'
    along its largest divisible axis. What the split shards is the
    optimizer's side: the masters it steps, their moments and the best
    copy (``parallel/fsdp.py``). The forward reads a working copy gathered
    whole once a step, so a rank's parameters the forward reads do not
    shrink; its moments and best copy do, to ~1/n_data."""
    return _layout(model, mesh, tp=False, fsdp=True, min_leaf_elems=min_leaf_elems)


def fsdp_tp_param_shardings(model, mesh, min_leaf_elems: int = FSDP_MIN_LEAF_ELEMS
                            ) -> Dict[str, Spec]:
    """2-D weight sharding: 'model' per the TP rules, then the largest
    still-free divisible axis of every big leaf over 'data'."""
    return _layout(model, mesh, tp=True, fsdp=True, min_leaf_elems=min_leaf_elems)


def opt_state_shardings(optimizer, mesh) -> dict:
    """The optimizer state's specs, in ``optimizer.state_dict()``'s
    numbering: ``{"state": {i: {name: spec}}, "count": (), "lr": ()}``.
    Parameter i's moments (and EMA) take the spec its layout gave it (the
    Trainer records it on the optimizer as ``param_specs``; replicated
    without one), so FSDP shards them n_data-way and TP stops replicating
    the model-sharded ones; the step count and lr are replicated 0-d
    tensors."""
    specs = getattr(optimizer, "param_specs", {})
    state, i = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            spec = specs.get(p, (None,) * p.dim())
            for axis in spec:
                if axis is not None and axis not in mesh.shape:
                    raise ValueError(f"the spec {spec} names an axis the mesh {mesh.shape} lacks")
            state[i] = {name: spec for name in optimizer.state[p]}
            i += 1
    return {"state": state, "count": (), "lr": ()}


def local_shape(shape, spec: Spec, mesh, axes=(DATA_AXIS, MODEL_AXIS)) -> tuple:
    """A rank's piece of a tensor of ``shape`` under ``spec``, split along
    the named ``axes`` only."""
    return tuple(s // mesh.shape[a] if a in axes else s for s, a in zip(shape, spec))
