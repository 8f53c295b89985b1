"""Weight bridge between the reference's param tree and the port's parameters.

The reference keeps parameters as a nested tree of dicts and lists
(``{"embed": {"wte": ...}, "layers": [{"ln1": {"scale": ...}, ...}], ...}``);
the port keeps them as ``nn.Module`` state whose state-dict names are the
same paths joined with dots (``embed.wte``, ``layers.0.ln1.scale``). With
the tree's leaves as numpy arrays (``jax.device_get`` of the reference's
params), `params_from_numpy` gives the port's state dict with the same
names, shapes and dtypes, and `params_to_numpy` is its inverse. Tests use
the bridge so both packages compute from identical weights. The module
itself needs only numpy and torch.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, "%s%s." % (prefix, k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, "%s%d." % (prefix, i), out)
    else:
        out[prefix[:-1]] = tree


def params_from_numpy(tree: Any, device="cpu") -> Dict[str, torch.Tensor]:
    """Nested param tree with numpy leaves -> flat state dict on `device`
    (load it with ``TransformerLM.load_state_dict``)."""
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    return {name: torch.from_numpy(np.array(leaf, copy=True)).to(device)
            for name, leaf in flat.items()}


def params_to_numpy(params: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, Any]:
    """The port's parameters (a module or its state dict) -> the reference's
    nested tree with numpy leaves; numeric path parts become list indices."""
    state = params.state_dict() if isinstance(params, nn.Module) else params
    root: Dict[str, Any] = {}
    for name, tensor in state.items():
        parts = name.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = tensor.detach().cpu().numpy()
    return _lists_from_int_keys(root)


def _lists_from_int_keys(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    out = {k: _lists_from_int_keys(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out
