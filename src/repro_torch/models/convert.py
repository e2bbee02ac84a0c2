"""Weights and caches carried across from the reference's pytrees.

The reference keeps each position of the block pattern stacked over depth
(``{"embed", "final_norm", "lm_head", "groups": {"pos0": [n_full, ...]},
"tail": [...]}``); the port keeps one :class:`Block` per layer.  Both keep
dense weights as ``[d_in, d_out]``, so the port computes ``x @ w`` on the
same matrices.  Arrays come in as numpy (``np.asarray`` of the reference's).
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch

from .attention import Attention
from .layers import MLP, Dense
from .transformer import Block, Transformer, _check_supported, layer_plan

__all__ = ["from_reference_params", "from_reference_caches"]


def _tensor(x, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    a = np.array(x)  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits across
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.dim() >= 2 and t.dtype == torch.float32:
        t = t.to(dtype)
    return t.to(device)


def _layer_trees(tree: Mapping, cfg) -> List[Mapping]:
    """The reference's per-layer subtrees, in depth order."""
    n_full, pat, _ = layer_plan(cfg)
    groups = tree.get("groups", {})
    layers = []
    for gi in range(n_full):
        for j in range(len(pat)):
            layers.append(_index(groups[f"pos{j}"], gi))
    return layers + list(tree.get("tail", []))


def _index(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def from_reference_params(params: Mapping, cfg, *, device="cpu",
                          dtype: Optional[torch.dtype] = None) -> Transformer:
    """The port's weights from the reference's parameter pytree.

    With ``dtype``, float32 weights of two or more dimensions are stored in
    it (the reference's ``cast_params``); 1-D weights keep their dtype.
    """
    _check_supported(cfg)
    dev = torch.device(device)

    def t(x):
        return _tensor(x, dev, dtype)

    def dense(p):
        return Dense(t(p["w"]), t(p["b"]) if "b" in p else None)

    blocks = []
    for p in _layer_trees(params, cfg):
        a, f = p["attn"], p["ffn"]
        blocks.append(Block(
            ln1=t(p["ln1"]),
            attn=Attention(dense(a["wq"]), dense(a["wk"]), dense(a["wv"]), dense(a["wo"])),
            ln2=t(p["ln2"]),
            ffn=MLP(w_up=t(f["w_up"]), w_down=t(f["w_down"]),
                    w_gate=t(f["w_gate"]) if "w_gate" in f else None),
        ))
    head = params.get("lm_head")
    return Transformer(cfg, t(params["embed"]), t(params["final_norm"]),
                       None if head is None else t(head), blocks)


def from_reference_caches(caches: Mapping, cfg, *, device="cpu") -> List[dict]:
    """The port's caches (one ``{"k", "v", "slot_pos"}`` per layer) from the
    reference's (``{"groups": {"pos0": stacked}, "tail": [...]}``)."""
    _check_supported(cfg)
    dev = torch.device(device)
    return [{k: _tensor(layer[k], dev) for k in ("k", "v", "slot_pos")}
            for layer in _layer_trees(caches, cfg)]
