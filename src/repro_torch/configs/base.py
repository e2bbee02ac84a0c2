"""Architecture configuration schema: a copy of the reference's
``ArchConfig``, ``ShardingConfig``, ``ShapeSpec`` and ``SHAPES``
(``repro/configs/base.py``).

Every architecture is a frozen :class:`ArchConfig`; ``reduced()`` derives
the CPU test configuration (same family and topology, tiny widths).
``ShardingConfig`` holds every field of the reference's, and the port
reads all of them but ``grad_compression`` (see its docstring).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ArchConfig", "SHAPES", "ShapeSpec", "ShardingConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention details
    attn_bias: bool = False  # qwen-style QKV bias
    window: int = 0  # sliding-window attention (mixtral); 0 = full
    local_window: int = 2048  # hybrid local-attention window
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_sharding: str = "ep"  # 'ep' (experts over model axis) | 'tp'
    capacity_factor: float = 1.25

    # layer pattern, cycled over depth.  elements:
    #   'attn' (global self-attn block), 'local' (windowed attn),
    #   'rwkv' (RWKV6 time/channel mix), 'rglru' (RG-LRU recurrent block),
    #   'cross' (cross-attention block consuming encoder/vision context)
    block_pattern: Tuple[str, ...] = ("attn",)

    # encoder-decoder (whisper): encoder layers with bidirectional attn
    encoder_layers: int = 0
    encoder_context: int = 1500  # default frames for stub frontend tests

    # vlm: stubbed number of image tokens prepended as cross-attn context
    num_image_tokens: int = 0

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "swiglu"  # swiglu | gelu

    # source annotation (public literature reference)
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so embed/lm_head shard over the model axis
        (e.g. whisper's 51865, granite's 49155); pad logits are masked."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def attention_free(self) -> bool:
        return all(b in ("rwkv", "rglru") for b in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if decode-state is O(1)/bounded (long_500k eligible)."""
        has_global_attn = any(b in ("attn", "cross") for b in self.block_pattern)
        return (not has_global_attn) or (self.window > 0)

    def params_count(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qkv = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        dense_ff = 3 * d * f if self.act == "swiglu" else 2 * d * f
        per_layer = 0
        counts = {
            "attn": qkv + dense_ff,
            "local": qkv + dense_ff,
            "cross": qkv + dense_ff,
            "rwkv": 4 * d * d + 2 * d * self.d_ff,  # time-mix + channel-mix
            "rglru": 2 * d * d + d * self.d_ff * 3,  # conv/gates + mlp
        }
        if self.num_experts:
            counts["attn"] = qkv + self.num_experts * dense_ff
        n = 0
        for i in range(self.num_layers):
            n += counts[self.block_pattern[i % len(self.block_pattern)]]
        n += v * d * (1 if self.tie_embeddings else 2)
        n += self.encoder_layers * (qkv + dense_ff)
        return n

    def active_params_count(self) -> int:
        """Active (per-token) parameters — MoE uses experts_per_token."""
        if not self.num_experts:
            return self.params_count()
        d, f = self.d_model, self.d_ff
        dense_ff = 3 * d * f if self.act == "swiglu" else 2 * d * f
        inactive = (self.num_experts - self.experts_per_token) * dense_ff
        return self.params_count() - self.num_layers * inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat_len = len(self.block_pattern)
        layers = max(pat_len, 2)
        if self.encoder_layers:
            layers = 2
        kv = max(1, min(self.num_kv_heads, 2))
        heads = max(kv, 4)
        heads = (heads // kv) * kv
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=layers,
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.num_experts else 0,
            window=min(self.window, 32) if self.window else 0,
            local_window=32,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_context=16,
            num_image_tokens=min(self.num_image_tokens, 8),
        )


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """How a model maps onto the mesh: the reference's fields and defaults.

    On one device only ``remat`` and ``attn_chunk`` apply.  On a ``[pod x]
    data x model`` mesh the port reads ``batch_axes`` (the data-parallel
    axes the batch splits over, the subset the mesh has: ``("pod",
    "data")`` on the multi-pod mesh), ``model_axis`` (tensor and expert
    parallelism), ``fsdp`` (ZeRO-3: weights sharded over ``data`` and
    gathered where used), ``zero1`` (AdamW's ``m`` and ``v`` sharded over ``data``) and
    ``moe_pipeline`` (the experts' exchange as ``grouped_exchange``).
    ``seq_axis="model"`` is sequence parallelism (``sp_dim`` 1: the
    stream's sequence, 2: its channels, split over the model axis between
    blocks; the port takes no other sequence axis) and ``attn_anchor``
    gives each model rank its own q heads (``models.layers.MeshShard``).
    FSDP and ZeRO-1 split over ``data`` alone: the weights are whole
    across pods, as in the reference.
    ``grad_compression`` is a field the reference's train step never reads,
    and the port's does not read it either (the int8 ring is a library
    function, ``comm.compress``)."""

    batch_axes: Tuple[str, ...] = ("pod", "data")  # DP axes (present subset used)
    model_axis: str = "model"  # TP / EP axis
    fsdp: bool = False  # shard weights over the data axis (ZeRO-3)
    zero1: bool = True  # shard optimizer state over the data axis
    seq_axis: Optional[str] = None  # sequence parallelism axis (long prefill)
    remat: str = "full"  # full | dots | none
    moe_pipeline: bool = False  # pipelined (grouped) MoE all-to-all
    grad_compression: Optional[str] = None  # None | 'int8'
    attn_anchor: bool = False  # explicit head sharding anchors
    attn_chunk: int = 1024  # chunked-attention tile (q and kv)
    #: which activation dim shards over ``seq_axis``: 1 = sequence
    #: (Megatron SP), 2 = channels (natural for per-channel recurrent archs)
    sp_dim: int = 1


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
