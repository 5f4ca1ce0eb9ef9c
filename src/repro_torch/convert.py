"""Carry state and weights across between the JAX package and the port.

NLINV has no weights: what a run carries is the Newton state, the
``{"u": {rho, chat}, "x_ref": {rho, chat}}`` of ``FrameStream.last_carry``
(or one ``{rho, chat}`` dict).  Both packages meet in numpy: turn a JAX
carry into arrays with ``np.asarray`` leaf by leaf, hand it to
:func:`carry_from_numpy`, and get it back with :func:`carry_to_numpy`.
Frame constants (mask, fov, weight) go through the same helper.  On N
ranks the carry is segmented: :func:`segmented_from_numpy` makes each
rank's containers of the global arrays by policy (``U_POLICIES``:
``rho`` CLONE, ``chat`` NATURAL), and :func:`segmented_to_numpy` gathers
them back.

An LM carries weights: :func:`params_from_numpy` maps the JAX package's
parameter pytree (as numpy arrays) onto the port's ``Transformer`` and
:func:`params_to_numpy` maps it back, so that both packages compute with
the same weights.  With a ``mesh`` it slices each leaf by its partition
spec before the upload, so a rank holds only its shards.
:func:`shape_tree` and :func:`cache_shape_tree` give the JAX layout of a
model's or a cache's shapes (meta tensors will do), for the spec
functions.  A train state carries the same way
(:func:`train_state_from_numpy`): the parameters, AdamW's ``m`` and ``v``
(trees of the parameters' layout) and ``step``, whole or as this rank's
shards.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def carry_from_numpy(tree, device=None):
    """Nested dicts of arrays -> the same dicts of tensors on ``device``
    (the card when None), dtypes kept.  Always copies, so an in-place
    update of the carry never writes into the caller's arrays."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: carry_from_numpy(v, dev) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=dev)


def carry_to_numpy(tree):
    """Nested dicts of tensors -> the same dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: carry_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def segmented_from_numpy(tree, comm, policy=None, dim: int = 0):
    """Global numpy arrays (a JAX run's carry, say; nested dicts allowed)
    -> this rank's containers on ``comm``.  ``policy`` is a ``Policy``, a
    ``(Policy, dim)`` pair or a dict of them by leaf name (NATURAL along
    ``dim`` by default); a policy dict applies at every depth whose keys
    it names."""
    from .core.segmented import Policy
    if policy is None:
        policy = Policy.NATURAL
    if isinstance(tree, dict):
        by_key = isinstance(policy, dict) and set(tree) <= set(policy)
        return {k: segmented_from_numpy(v, comm,
                                        policy[k] if by_key else policy, dim)
                for k, v in tree.items()}
    pol, d = policy if isinstance(policy, tuple) else (policy, dim)
    return comm.container(np.asarray(tree), policy=pol, dim=d)


def segmented_to_numpy(tree):
    """Containers (nested dicts allowed) -> their logical arrays, gathered
    from every rank, as numpy."""
    if isinstance(tree, dict):
        return {k: segmented_to_numpy(v) for k, v in tree.items()}
    return tree.gather().detach().cpu().numpy()


# -- model parameters --------------------------------------------------------

def _leaves(tree, prefix=""):
    """(dotted path, leaf) pairs of nested dicts, in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _layer_slots(cfg):
    """(group, repeats, repeat, unit position) of each unrolled layer."""
    from .models.transformer import layer_groups
    return [(gi, reps, r, j)
            for gi, (unit, reps) in enumerate(layer_groups(cfg))
            for r in range(reps) for j in range(len(unit))]


def port_leaves(cfg, tree, take=lambda leaf, r: leaf[r],
                whole=lambda leaf: leaf) -> dict:
    """The leaves of a tree in the JAX package's parameter layout, keyed by
    the port's parameter names: a leaf of a stacked group (or of the
    encoder's stacked layers) gives ``take(leaf, r)`` for each repeat
    ``r``, any other leaf ``whole(leaf)``."""
    state = {name: whole(leaf) for name, leaf in _leaves(
        {k: v for k, v in tree.items() if k not in ("groups", "encoder")})}
    if "encoder" in tree:
        enc = tree["encoder"]
        state.update((name, whole(leaf)) for name, leaf in _leaves(
            {k: v for k, v in enc.items() if k != "layers"}, "encoder."))
        for name, leaf in _leaves(enc["layers"]):
            for i in range(cfg.encoder_layers):
                state[f"encoder.layers.{i}.{name}"] = take(leaf, i)
    for layer, (gi, reps, r, j) in enumerate(_layer_slots(cfg)):
        for name, leaf in _leaves(tree["groups"][gi][f"l{j}"]):
            state[f"layers.{layer}.{name}"] = take(leaf, r) if reps > 1 \
                else whole(leaf)
    return state


def params_from_numpy(cfg, tree, device=None, *, mesh=None, tp="model",
                      fsdp=("data",)):
    """The JAX package's parameter pytree, as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``, stacked groups included) -> the
    port's :class:`~repro_torch.models.transformer.Transformer` on
    ``device`` (the card when None), each weight cast to the dtype the port
    stores it in.  The stacked units of repeated groups (MoE's ``experts``
    among them) map onto the unrolled layers, and the encoder's stacked
    ``encoder.layers`` onto its unrolled layers.  Raises when a leaf has no
    parameter or a parameter no leaf.

    ``mesh`` (a ``Communicator`` or ``DeviceGroup`` with named axes): this
    rank's shards, each leaf sliced by ``param_pspecs(tp=, fsdp=)`` in numpy
    before it goes to the rank's device (``models.sharding``)."""
    from .models.transformer import Transformer
    state = port_leaves(cfg, tree)
    pad = _expert_pad(cfg, tree)
    if mesh is not None:
        from .models import sharding
        return sharding.assemble(
            cfg, mesh, lambda name, take: torch.from_numpy(np.array(
                take(np.asarray(state[name])))),
            tp=tp, fsdp=fsdp, expert_pad=pad, names=set(state))
    dev = resolve_device(device)
    model = Transformer(cfg, device="meta", expert_pad=pad).to_empty(
        device=dev)
    params = dict(model.named_parameters())
    _check_names(params, state)
    with torch.no_grad():
        for name, p in params.items():
            leaf = np.asarray(state[name])
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {leaf.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(leaf)))
    return model


def train_state_from_numpy(cfg, tree, device=None, *, mesh=None,
                          tp="model", fsdp=("data",)):
    """The JAX package's train state as numpy (``{"params": tree, "opt":
    {"m": tree, "v": tree, "step": n}}``; without ``"opt"``, AdamW's zero
    state) -> the port's: the parameters as :func:`params_from_numpy`
    makes them (this rank's shards with ``mesh``), with gradients on, and
    ``m``/``v`` keyed by parameter name, float32, of the parameters'
    shapes (each leaf sliced by its spec in ``train.state_shardings``)."""
    from .train.optimizer import adamw_init
    model = params_from_numpy(cfg, tree["params"], device, mesh=mesh, tp=tp,
                              fsdp=fsdp)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    if "opt" not in tree:
        return {"params": model, "opt": opt}
    cuts = {name: () for name in params}
    if mesh is not None:
        from .models import sharding
        from .train.trainer import state_shardings
        specs = state_shardings(cfg, {"params": model}, mesh, fsdp=fsdp,
                                tp=tp)["opt"]
        cuts = {name: sharding.local_slices(
            np.shape(leaf), specs["m"][name], sharding._group(mesh))
            for name, leaf in port_leaves(cfg, tree["opt"]["m"]).items()}
    with torch.no_grad():
        for k in ("m", "v"):
            for name, leaf in port_leaves(cfg, tree["opt"][k]).items():
                opt[k][name].copy_(torch.from_numpy(np.array(
                    np.asarray(leaf)[cuts[name]], dtype=np.float32)))
        opt["step"].fill_(int(np.asarray(tree["opt"]["step"])))
    return {"params": model, "opt": opt}


def _expert_pad(cfg, tree) -> int:
    """An ``expert_pad`` that gives the tree's expert count (1 without MoE
    or padding): a count ``Ep`` over ``n_experts`` pads to itself."""
    for name, leaf in port_leaves(cfg, tree).items():
        if name.endswith(".moe.router"):
            ep = int(np.shape(leaf)[-1])
            return ep if ep != cfg.n_experts else 1
    return 1


def _check_names(params, state) -> None:
    if set(params) != set(state):
        raise ValueError(f"parameter trees differ: only in the port "
                         f"{sorted(set(params) - set(state))}, only in the "
                         f"JAX tree {sorted(set(state) - set(params))}")


def _nest(flat):
    """{"a.b": x} -> {"a": {"b": x}}."""
    tree = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _stack(trees, stack=np.stack):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)


def _size_stack(sizes):
    return torch.Size((len(sizes), *sizes[0]))


def params_to_numpy(cfg, model):
    """The inverse of :func:`params_from_numpy`: the JAX package's tree
    layout, groups and encoder layers stacked, every leaf a float32 numpy
    array."""
    return named_to_numpy(cfg, dict(model.named_parameters()))


def named_to_numpy(cfg, named: dict):
    """Tensors keyed by the port's parameter names (the parameters, or
    their gradients) -> the JAX package's tree layout, as
    :func:`params_to_numpy`: the map only moves and stacks leaves, so a
    gradient maps onto the JAX gradient of the same leaf."""
    return _jax_layout(cfg, {name: t.detach().float().cpu().numpy()
                             for name, t in named.items()})


def shape_tree(cfg, model):
    """The JAX package's parameter tree of a model's shapes
    (``torch.Size`` leaves, a stacked group's with its leading repeat
    dim), without reading a weight: a ``device="meta"`` model serves."""
    return _jax_layout(cfg, {name: p.shape for name, p in
                             model.named_parameters()}, _size_stack)


def cache_shape_tree(cfg, caches):
    """The JAX package's cache tree (one entry per layer group, a repeated
    group's leaves stacked) of the shapes of the port's cache (one dict
    per layer; meta tensors serve)."""
    from .models.transformer import layer_groups
    out, layer = [], 0
    for unit, reps in layer_groups(cfg):
        units = []
        for _ in range(reps):
            units.append({f"l{j}": _shapes(caches[layer + j])
                          for j in range(len(unit))})
            layer += len(unit)
        out.append(_stack(units, _size_stack) if reps > 1 else units[0])
    return out


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tree.shape


def _jax_layout(cfg, flat, stack=np.stack):
    """Leaves keyed by the port's parameter names -> the JAX tree layout:
    the groups' units and the encoder's layers stacked with ``stack``."""
    tree = {k: v for k, v in flat.items()
            if not k.startswith(("layers.", "encoder."))}
    if cfg.encoder_layers:
        enc = _nest({k[len("encoder."):]: v for k, v in flat.items()
                     if k.startswith("encoder.")
                     and not k.startswith("encoder.layers.")})
        enc["layers"] = _stack([_nest(
            {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)})
            for pre in (f"encoder.layers.{i}."
                        for i in range(cfg.encoder_layers))], stack)
        tree["encoder"] = enc
    units: dict[int, dict[str, list]] = {}
    for layer, (gi, _, _, j) in enumerate(_layer_slots(cfg)):
        prefix = f"layers.{layer}."
        one = _nest({k[len(prefix):]: v for k, v in flat.items()
                     if k.startswith(prefix)})
        units.setdefault(gi, {}).setdefault(f"l{j}", []).append(one)
    tree["groups"] = [{lj: _stack(reps, stack) if len(reps) > 1 else reps[0]
                       for lj, reps in units[gi].items()}
                      for gi in sorted(units)]
    return tree
