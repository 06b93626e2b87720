"""The weight bridge between the JAX package's variable trees and the port.

The reference's variables are nested dicts (``wte/embedding``,
``h_0/attn/qkv/kernel``, ...; ``batch_stats`` beside ``params`` for a
ResNet). Handed over as nested dicts of numpy arrays, or as an ``.npz``
of the flattened tree with ``/``-joined keys, they load unchanged into
the port's modules, whose ``state_dict`` keys are the same paths with
``.`` for ``/`` in the same layouts:

* GPT-2 (``models/transformer.GPT2``), an MoE block's
  ``h_i/moe/{gate,w_in,b_in,w_out,b_out}`` included;
* BERT (``models/bert.BertClassifier``): qkv ``[d, 3, H, hd]``, proj
  ``[H, hd, d]``, ``classifier`` beside ``bert``;
* ResNet (``models/resnet.ResNet``): conv kernels HWIO, each BatchNorm's
  ``scale``/``bias`` from ``params`` and ``mean``/``var`` (the module's
  buffers) from ``batch_stats``;
* the MLP (``models/mlp.MLP``).

:func:`variables_from_tree` gives the trainer's flat ``{name: tensor}``
dicts of such a tree; :func:`to_param_tree` is the other direction: a
module, or a trainer's params, back to the nested numpy tree the JAX
package loads. The port never sees a jax array.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tensorflow_examples_torch.models.transformer import GPT2, TransformerConfig


def flatten_tree(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts -> ``{"a/b/c": array}``."""
    flat: dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_tree(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def save_npz(path: str, params: Mapping) -> None:
    """Write a (nested or flat) param tree as a flat ``.npz``."""
    np.savez(path, **flatten_tree(params))


def variables_from_tree(variables: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    """A flax variables tree (``{"params": ..., "batch_stats": ...}``)
    as ``{collection: {"a.b.c": f32 tensor}}``, the trainer's layout
    (``params``, and ``TrainState.model_state`` for the rest)."""
    return {name: {k.replace("/", "."): torch.as_tensor(np.array(v, np.float32))
                   for k, v in flatten_tree(tree).items()}
            for name, tree in variables.items()}


def load_params(model: torch.nn.Module, params: Mapping,
                batch_stats: Mapping | None = None) -> torch.nn.Module:
    """Copy a JAX-layout param tree (nested or ``/``-flattened), and a
    ResNet's ``batch_stats`` tree into its buffers, into ``model`` in
    place. Every path must be present with the module's shape; extra or
    missing paths raise, naming them."""
    flat = {**flatten_tree(params), **flatten_tree(batch_stats or {})}
    own = {k.replace(".", "/"): t for k, t in model.state_dict().items()}
    missing, extra = sorted(own.keys() - flat.keys()), sorted(flat.keys() - own.keys())
    if missing or extra:
        raise ValueError(f"param tree mismatch: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for path, tensor in own.items():
            src = flat[path]
            if tuple(src.shape) != tuple(tensor.shape):
                raise ValueError(
                    f"{path}: shape {tuple(src.shape)} != module's {tuple(tensor.shape)}"
                )
            tensor.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
    return model


def model_from_params(cfg: TransformerConfig, params: Mapping, *,
                      device: str | torch.device = "cpu") -> GPT2:
    """A :class:`GPT2` on ``device`` holding ``params`` (no random init)."""
    model = GPT2(cfg, device="meta").to_empty(device=device)
    return load_params(model, params)


def to_param_tree(params) -> dict:
    """A :class:`GPT2` (or a ``{"a.b.c": tensor}`` dict such as
    ``TrainState.params``) -> the reference's nested tree of f32 numpy
    arrays (``{"a": {"b": {"c": array}}}``)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    tree: dict = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree
