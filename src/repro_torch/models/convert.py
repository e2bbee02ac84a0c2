"""Weights and caches carried across from the reference's pytrees.

The reference keeps each position of the block pattern stacked over depth
(``{"embed", "final_norm", "lm_head", "groups": {"pos0": [n_full, ...]},
"tail": [...], "encoder": {"blocks": [...], "final_norm"}}``); the port
keeps one block module per layer, of its layer's kind.  Both keep dense
weights as ``[d_in, d_out]`` and experts as ``[E, d_in, d_out]`` stacks, so
the port computes on the same matrices.  Arrays come in as numpy
(``np.asarray`` of the reference's).  A tree shaped like the weights (the
gradients, AdamW's ``m`` and ``v``) maps by the same rule onto the port's
weight names (:func:`from_reference_named`, :func:`from_reference_opt_state`).
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch

from .attention import Attention
from .layers import MLP, Dense
from .moe import MoE
from .rglru import RgLru
from .rwkv6 import RwkvChannel, RwkvTime
from .transformer import (
    AttnCrossBlock,
    Block,
    CrossBlock,
    Encoder,
    EncoderBlock,
    RglruBlock,
    RwkvBlock,
    Transformer,
    _check_supported,
    layer_kinds,
    layer_plan,
)

__all__ = ["from_reference_params", "from_reference_named", "from_reference_opt_state",
           "from_reference_caches"]


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

    def attn(a):
        return Attention(dense(a["wq"]), dense(a["wk"]), dense(a["wv"]), dense(a["wo"]))

    def ffn(f):
        if "router" in f:
            return MoE(t(f["router"]), t(f["w_gate"]), t(f["w_up"]), t(f["w_down"]))
        return MLP(w_up=t(f["w_up"]), w_down=t(f["w_down"]),
                   w_gate=t(f["w_gate"]) if "w_gate" in f else None)

    def block(kind, p):
        if kind in ("attn", "local"):
            return Block(ln1=t(p["ln1"]), attn=attn(p["attn"]), ln2=t(p["ln2"]),
                         ffn=ffn(p["ffn"]), kind=kind)
        if kind == "cross":
            return CrossBlock(ln1=t(p["ln1"]), xattn=attn(p["xattn"]), ln2=t(p["ln2"]),
                              ffn=ffn(p["ffn"]), xgate=t(p["xgate"]))
        if kind == "attn_cross":
            return AttnCrossBlock(ln1=t(p["ln1"]), attn=attn(p["attn"]), ln_c=t(p["ln_c"]),
                                  xattn=attn(p["xattn"]), ln2=t(p["ln2"]), ffn=ffn(p["ffn"]))
        if kind == "rwkv":
            tm, ch = p["time"], p["channel"]
            time = RwkvTime(**{k: t(tm[k]) for k in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w",
                                                      "w_base", "w_lora_a", "w_lora_b",
                                                      "u_bonus", "ln_x")},
                            **{k: dense(tm[k]) for k in ("wr", "wk", "wv", "wg", "wo")})
            channel = RwkvChannel(t(ch["mix_k"]), dense(ch["wk"]), dense(ch["wv"]))
            return RwkvBlock(ln1=t(p["ln1"]), time=time, channel=channel, ln2=t(p["ln2"]))
        r = p["rec"]
        rec = RgLru(w_in=dense(r["w_in"]), w_gate=dense(r["w_gate"]), conv_w=t(r["conv_w"]),
                    conv_b=t(r["conv_b"]), lru_a=dense(r["lru_a"]), lru_x=dense(r["lru_x"]),
                    lambda_raw=t(r["lambda_raw"]), w_out=dense(r["w_out"]))
        return RglruBlock(ln1=t(p["ln1"]), rec=rec, ln2=t(p["ln2"]), ffn=ffn(p["ffn"]))

    blocks = [block(kind, p) for kind, p in zip(layer_kinds(cfg), _layer_trees(params, cfg))]
    encoder = None
    if "encoder" in params:
        enc = params["encoder"]
        encoder = Encoder([EncoderBlock(ln1=t(b["ln1"]), attn=attn(b["attn"]), ln2=t(b["ln2"]),
                                        ffn=ffn(b["ffn"])) for b in enc["blocks"]],
                          t(enc["final_norm"]))
    head = params.get("lm_head")
    return Transformer(cfg, t(params["embed"]), t(params["final_norm"]),
                       None if head is None else t(head), blocks, encoder)


def from_reference_named(tree: Mapping, cfg, *, device="cpu") -> dict:
    """A tree shaped like the reference's weights (its gradients, say) as
    ``{port weight name: tensor}``, the names of
    ``from_reference_params(...).named_parameters()``; no dtype cast."""
    return {k: v.detach() for k, v in from_reference_params(tree, cfg, device=device)
            .named_parameters()}


def from_reference_opt_state(state: Mapping, cfg, *, device="cpu") -> dict:
    """The reference's AdamW state ``{"m", "v", "step"}`` as the port's:
    ``m`` and ``v`` by weight name (:func:`from_reference_named`), ``step``
    an int32 scalar on the CPU (``train/optimizer.py``)."""
    return {"m": from_reference_named(state["m"], cfg, device=device),
            "v": from_reference_named(state["v"], cfg, device=device),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32)}


def from_reference_caches(caches: Mapping, cfg, *, device="cpu") -> List[dict]:
    """The port's caches, one dict per layer with the reference's keys
    (``{"k", "v", "slot_pos"}``, ``{"xk", "xv"}``, ``{"wkv", "x_prev_t",
    "x_prev_c"}``, ``{"h", "conv"}``), from the reference's
    (``{"groups": {"pos0": stacked}, "tail": [...]}``)."""
    _check_supported(cfg)
    dev = torch.device(device)
    return [{k: _tensor(v, dev) for k, v in layer.items()}
            for layer in _layer_trees(caches, cfg)]
