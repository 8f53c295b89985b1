"""Weight bridge between the reference's param tree and the port's parameters.

The reference keeps parameters as a nested tree of dicts and lists
(``{"embed": {"wte": ...}, "layers": [{"ln1": {"scale": ...}, ...}], ...}``);
the port keeps them as ``nn.Module`` state whose state-dict names are the
same paths joined with dots (``embed.wte``, ``layers.0.ln1.scale``). With
the tree's leaves as numpy arrays (``jax.device_get`` of the reference's
params), `params_from_numpy` gives the port's state dict with the same
names, shapes and dtypes, and `params_to_numpy` is its inverse. The Adam
moments cross the same way: optax's ``ScaleByAdamState`` (count, mu, nu —
mu and nu are param-shaped trees) to the port's `AdamState` with
`adam_state_from_numpy`, and back with `adam_state_to_numpy`. Tests use the
bridge so both packages compute from identical weights and optimizer state.
Any family's tree crosses as it is (GPT's qkv/out/mlp biases, LayerNorm
biases and position table, and no separate head under its tied
embedding; BERT's ``embed.tte``, ``embed.norm`` and MLM ``head``; ViT's
``embed.patch``, ``embed.cls_token`` and classification ``head``; T5's
``enc_layers`` / ``dec_layers`` with their ``cross`` attention, its two
relative tables and two final norms, into ``models.t5.T5Model``; Swin's
``blocks`` of per-stage widths, its ``merges`` and relative tables, into
``models.swin.SwinModel``). A pipelined tree of the generic family, whose
layers the reference stacks over its stages (``stages``), is read back into
the canonical ``layers`` list (`unstack_tree`); T5's and Swin's pipelined
trees (the reference's padded universal slots) are not read: the port
never stacks them. Under a sharded layout each rank keeps its shards of the full
state dict (``runtime.model_api.HybridParallelModel.shard_params``;
``gather_params`` and ``gather_opt_state`` go back).
The module itself needs only numpy and torch.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

from galvatron_tpu_torch.runtime.optimizer import AdamState


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, "%s%s." % (prefix, k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, "%s%d." % (prefix, i), out)
    else:
        out[prefix[:-1]] = tree


def unstack_tree(tree: Mapping, hp) -> Dict[str, Any]:
    """A pipelined reference tree, whose layers sit in ``stages`` (one tree
    per within-stage slot, leaves stacked over pp, the short stages of an
    uneven division zero-padded), -> the canonical tree with ``layers``
    (``parallel.pipeline.unstack_params`` under the strategy `hp`)."""
    from galvatron_tpu_torch.parallel.pipeline import unstack_params

    out = {k: v for k, v in tree.items() if k != "stages"}
    out["layers"] = unstack_params(tree["stages"], hp)
    return out


def params_from_numpy(tree: Any, device="cpu", hp=None) -> Dict[str, torch.Tensor]:
    """Nested param tree with numpy leaves -> flat state dict on `device`
    (load it with ``TransformerLM.load_state_dict``). A pipelined tree
    (``stages``) needs its strategy `hp` and comes back canonical."""
    if isinstance(tree, Mapping) and "stages" in tree:
        if hp is None:
            raise ValueError("a tree with 'stages' is laid out by its pipeline strategy: "
                             "pass hp to unstack it")
        tree = unstack_tree(tree, hp)
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


def adam_state_from_numpy(count: Any, mu: Any, nu: Any, device="cpu") -> AdamState:
    """optax ScaleByAdamState fields (numpy leaves) -> the port's AdamState."""
    return AdamState(count=int(np.asarray(count)), mu=params_from_numpy(mu, device),
                     nu=params_from_numpy(nu, device))


def adam_state_to_numpy(state: AdamState) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """The port's AdamState -> (count, mu tree, nu tree) with numpy leaves,
    the fields of optax's ScaleByAdamState."""
    return state.count, params_to_numpy(state.mu), params_to_numpy(state.nu)
