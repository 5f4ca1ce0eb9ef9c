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
the same weights.
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


def params_from_numpy(cfg, tree, device=None):
    """The JAX package's parameter pytree, as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``, stacked groups included) -> the
    port's :class:`~repro_torch.models.transformer.Transformer` on
    ``device`` (the card when None), each weight cast to the dtype the port
    stores it in.  The stacked units of repeated groups (MoE's ``experts``
    among them) map onto the unrolled layers, and the encoder's stacked
    ``encoder.layers`` onto its unrolled layers.  Raises when a leaf has no
    parameter or a parameter no leaf."""
    from .models.transformer import Transformer
    dev = resolve_device(device)
    state = {name: leaf for name, leaf in _leaves(
        {k: v for k, v in tree.items() if k not in ("groups", "encoder")})}
    if "encoder" in tree:
        enc = tree["encoder"]
        state.update(_leaves({k: v for k, v in enc.items() if k != "layers"},
                             "encoder."))
        for name, leaf in _leaves(enc["layers"]):
            for i in range(np.shape(leaf)[0]):
                state[f"encoder.layers.{i}.{name}"] = leaf[i]
    for layer, (gi, reps, r, j) in enumerate(_layer_slots(cfg)):
        for name, leaf in _leaves(tree["groups"][gi][f"l{j}"]):
            state[f"layers.{layer}.{name}"] = leaf[r] if reps > 1 else leaf
    model = Transformer(cfg, device="meta").to_empty(device=dev)
    params = dict(model.named_parameters())
    if set(params) != set(state):
        raise ValueError(f"parameter trees differ: only in the port "
                         f"{sorted(set(params) - set(state))}, only in the "
                         f"JAX tree {sorted(set(state) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            leaf = np.asarray(state[name])
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {leaf.shape} != "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(leaf)))
    return model


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


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


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
    flat = {name: t.detach().float().cpu().numpy()
            for name, t in named.items()}
    tree = {k: v for k, v in flat.items()
            if not k.startswith(("layers.", "encoder."))}
    if cfg.encoder_layers:
        enc = _nest({k[len("encoder."):]: v for k, v in flat.items()
                     if k.startswith("encoder.")
                     and not k.startswith("encoder.layers.")})
        enc["layers"] = _stack([_nest(
            {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)})
            for pre in (f"encoder.layers.{i}."
                        for i in range(cfg.encoder_layers))])
        tree["encoder"] = enc
    units: dict[int, dict[str, list]] = {}
    for layer, (gi, _, _, j) in enumerate(_layer_slots(cfg)):
        prefix = f"layers.{layer}."
        one = _nest({k[len(prefix):]: v for k, v in flat.items()
                     if k.startswith(prefix)})
        units.setdefault(gi, {}).setdefault(f"l{j}", []).append(one)
    tree["groups"] = [{lj: _stack(reps) if len(reps) > 1 else reps[0]
                       for lj, reps in units[gi].items()}
                      for gi in sorted(units)]
    return tree
