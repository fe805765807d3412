"""Architecture configuration (port of ``repro.configs.base``).

An :class:`ArchConfig` fully describes a model: the model functions build
parameter dictionaries and apply functions from it alone.  Layer stacks are
a repeating pattern of :class:`LayerSpec`s, factored by ``build_stages`` into
stages whose weights are stacked along a leading layer axis — the same
layout as the JAX package, so a weight tree crosses between the two with a
plain reshape.

Differences from the JAX config: dtypes are ``torch`` dtypes, one
``compute_dtype`` also stores the float weights, and there is no ``kernel_mode``
— a tensor's device chooses the kernel or its plain version.  Of the mesh
knobs, ``moe_shard_map`` (the serving engine and the mesh train step switch
it on for an expert-parallel mesh), ``fsdp`` (shard parameters and moments
over the data axis, ZeRO-3) and ``parallel_mode`` (``"2d"``: tensor
parallel over ``model`` and FSDP over ``data``; ``"fsdp"``: no tensor
parallelism, batch and parameters over both axes) are here, read by
``launch.sharding.profile_for`` and ``training.step.make_train_step``;
``use_torus_tp`` is read by no model code in the reference either; ``scan_layers`` serves only XLA's cost compile of the dry run (the
port's layer loop is the reference's unrolled path).  ``kind="encoder"``
(hubert) makes self-attention
bidirectional, as the reference's ``causal = cfg.kind == "decoder"``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Sequence

import torch


@dataclass(frozen=True)
class LayerSpec:
    mixer: str  # attn_global | attn_local | ssm | cross
    ffn: str    # dense | moe | none


@dataclass(frozen=True)
class Stage:
    """``repeats`` stacked iterations of a fixed ``group`` of layers."""

    group: tuple[LayerSpec, ...]
    repeats: int


def _is_periodic(specs: Sequence[LayerSpec], p: int) -> bool:
    return all(specs[i] == specs[i % p] for i in range(len(specs)))


def build_stages(specs: Sequence[LayerSpec]) -> list[Stage]:
    """Factor a layer list into <=2 stages (main periodic prefix + tail)."""
    n = len(specs)
    if n == 0:
        return []
    for p in range(1, n + 1):
        n_full = n // p
        if n_full == 0:
            break
        prefix = specs[: n_full * p]
        if _is_periodic(prefix, p) and n_full * p >= max(p, n // 2):
            stages = [Stage(tuple(specs[:p]), n_full)]
            tail = specs[n_full * p:]
            if tail:
                stages.extend(build_stages(tail))
            return stages
    return [Stage(tuple(specs), 1)]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    kind: str = "decoder"  # decoder | encoder (bidirectional, no decode)

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    local_global_pattern: int = 0
    window_size: int = 0
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0
    use_qk_norm: bool = False

    # Multi-head latent attention (MLA): low-rank q and a compressed
    # [latent | k_rope] KV cache of kv_lora_rank + qk_rope_dim columns
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE FFN: capacity-routed top-k over ``num_experts`` SwiGLU experts of
    # width ``moe_d_ff`` on every ``moe_every``-th layer, tokens routed in
    # ``num_moe_groups`` dispatch groups
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.0
    num_moe_groups: int = 1
    # expert-parallel dispatch over the mesh's model axis: each rank runs the
    # E/tp experts it holds and one f32 all-reduce merges the partial outputs
    # (``layers.moe_forward``); off by default, as the reference, and switched
    # on by the engine when ``E % model == 0``
    moe_shard_map: bool = False

    # Mamba-2 SSD: d_inner = ssm_expand * d_model in heads of ssm_headdim,
    # shared B/C of ssm_state, a depthwise causal conv of ssm_conv_width,
    # prefill in chunks of ssm_chunk; a hybrid has one attention layer every
    # ssm_every layers (0: pure SSM or no SSM)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_every: int = 0

    # VLM cross-attention: every cross_every-th layer adds a tanh-gated
    # cross-attention sub-block over vision_tokens patch embeddings of
    # width vision_dim, projected to d_model (the vision tower is a stub)
    cross_every: int = 0
    vision_tokens: int = 0
    vision_dim: int = 0

    # audio frontend stub: frame embeddings of width frontend_dim, projected
    # to d_model, take the place of the token embedding
    audio_frontend: bool = False
    frontend_dim: int = 0

    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_nonparam
    tie_embeddings: bool = False

    compute_dtype: Any = torch.bfloat16  # weights are stored in it too

    # activation rematerialisation of each layer group in a training step
    # (``models.model.forward_hidden``): none | dots_nb | dots | full
    remat_policy: str = "full"

    pad_heads_to: int = 1
    pad_vocab_to: int = 256
    fsdp: bool = True  # shard params / moments over the data axis (a mesh's train step)
    parallel_mode: str = "2d"  # "2d" (TP x FSDP) | "fsdp" (ZeRO-3 only)

    @property
    def padded_vocab(self) -> int:
        pv = self.pad_vocab_to
        return ((self.vocab_size + pv - 1) // pv) * pv

    @property
    def padded_heads(self) -> int:
        ph = self.pad_heads_to
        return ((self.num_heads + ph - 1) // ph) * ph

    @property
    def d_inner(self) -> int:  # SSD inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_specs(self) -> list[LayerSpec]:
        specs = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                mixer = "ssm"
            elif self.ssm_every:
                mixer = ("attn_global"
                         if (i % self.ssm_every) == self.ssm_every // 2
                         else "ssm")
            elif self.cross_every and ((i + 1) % self.cross_every == 0):
                mixer = "cross"
            elif self.local_global_pattern:
                p = self.local_global_pattern + 1
                mixer = ("attn_global" if (i % p) == self.local_global_pattern
                         else "attn_local")
            else:
                mixer = "attn_global"
            if self.num_experts and (i % self.moe_every == self.moe_every - 1):
                ffn = "moe"
            elif self.family == "ssm":
                ffn = "none"
            else:
                ffn = "dense"
            specs.append(LayerSpec(mixer, ffn))
        return specs

    def stages(self, main_repeats: int | None = None) -> list[Stage]:
        """The stacked stages; ``main_repeats`` overrides the repeats of the
        main (largest) stage, as the reference's depth cut for its
        roofline extrapolation (exact: a stage is homogeneous)."""
        stages = build_stages(self.layer_specs())
        if main_repeats is not None and stages:
            main = max(range(len(stages)), key=lambda i: stages[i].repeats)
            stages = [dataclasses.replace(s, repeats=main_repeats) if i == main else s
                      for i, s in enumerate(stages)]
        return stages

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (the reference's assigned shape set)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> str | None:
    """A reason string if this (arch x shape) cell is skipped, else None."""
    if cfg.kind == "encoder" and shape.step == "decode":
        return "encoder-only architecture has no autoregressive decode step"
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid") or cfg.local_global_pattern > 0
        if not sub_quadratic:
            return "pure full-attention arch: 524k dense-KV decode excluded per spec"
    return None
