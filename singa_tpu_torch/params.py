"""Weights: the port's seeded initialisation and the bridge from the JAX
package's flax parameter tree.

The port's module attributes carry the flax module names, so a flax path
maps to a state-dict key mechanically:
  * the leading ``params`` collection is dropped;
  * ``Dense_0`` / ``Embed_0`` wrapper levels are dropped; a Dense ``kernel``
    (``[in, out]``) becomes ``weight`` (``[out, in]``, transposed), an
    ``embedding`` table becomes ``weight``, a LayerNorm ``scale`` becomes
    ``weight``;
  * ``nn.scan`` stacks (``.../layers/layer/...`` with a leading layer axis)
    unstack into ``layers.0``, ``layers.1``, ...;
  * every other leaf (``w1``, ``gate_kernel``, ``q_lin``, ``w_m0``, a
    ``DenseGeneral`` ``kernel`` of flax attention, a parameter of the root
    module such as ``SeqDiscriminator``'s ``embedding``, ...) keeps its name
    and its flax layout.
Every leaf maps, ``model/encoder2/**`` included. A flax gradient tree has the
parameter tree's structure, so the same map carries ``jax.grad``'s output into
the port's names (``from_flax_grads``).
"""
from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def seeded_init(model: nn.Module, seed: int) -> None:
    """Initialise every parameter from ``seed`` with the JAX package's
    distributions, drawn on the CPU so every device gets the same weights.
    Draws follow module registration order (``model.modules()``)."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.LayerNorm):
            m.reset_parameters()
        elif hasattr(m, "init_params"):
            m.init_params(gen)


def _leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[tuple, np.ndarray]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k in sorted(tree.keys()):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield path, np.asarray(tree)


def _torch_entry(path: tuple, leaf: np.ndarray) -> tuple[str, np.ndarray]:
    name = path[-1]
    mods = [p for p in path[:-1] if p not in ("Dense_0", "Embed_0")]
    if name == "kernel" and "Dense_0" in path:
        return ".".join(mods + ["weight"]), np.ascontiguousarray(leaf.T)
    if name in ("scale", "embedding") and mods:
        return ".".join(mods + ["weight"]), leaf
    return ".".join(mods + [name]), leaf


def from_flax(tree: Any) -> dict[str, np.ndarray]:
    """Flax parameter tree (nested dict of arrays, as ``init`` returns it)
    -> port state dict of numpy arrays."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    out: dict[str, np.ndarray] = {}
    for path, leaf in _leaves(tree):
        if "layers" in path and path[path.index("layers") + 1 : path.index("layers") + 2] == ("layer",):
            j = path.index("layers")
            for i in range(leaf.shape[0]):
                key, val = _torch_entry(path[: j + 1] + (str(i),) + path[j + 2 :], leaf[i])
                out[key] = val
            continue
        key, val = _torch_entry(path, leaf)
        out[key] = val
    return out


def from_flax_grads(grads: Any) -> dict[str, np.ndarray]:
    """A flax gradient tree (``jax.grad`` of a loss in the parameters) ->
    gradients by port parameter name, in the port's layouts, to compare with
    ``{name: p.grad for name, p in model.named_parameters()}`` leaf by leaf."""
    return from_flax(grads)


@torch.no_grad()
def load_flax_params(module: nn.Module, tree: Any) -> None:
    """Load a flax (sub)tree into ``module``, which must be the port's
    counterpart of that tree. Raises on a leaf with no port parameter, on a
    shape mismatch and on any port parameter left unset."""
    sd = from_flax(tree)
    params = dict(module.named_parameters())
    extra = sorted(set(sd) - set(params))
    if extra:
        raise KeyError(f"flax leaves with no port parameter: {extra[:10]}")
    missing = sorted(set(params) - set(sd))
    if missing:
        raise KeyError(f"port parameters the flax tree does not set: {missing[:10]}")
    for key, val in sd.items():
        p = params[key]
        if tuple(p.shape) != val.shape:
            raise ValueError(f"{key}: port shape {tuple(p.shape)} vs flax {val.shape}")
        p.copy_(torch.tensor(val, dtype=p.dtype))
