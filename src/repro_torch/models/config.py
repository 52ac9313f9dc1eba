"""Model configuration for the assigned architecture pool.

One frozen dataclass covers all five families (dense / moe / ssm / hybrid /
encdec) plus modality-frontend stubs.  ``resolve_for_tp`` applies the
divisibility padding needed by tensor parallelism (heads and vocab padded to
multiples of the TP degree; padded head weights are zero so outputs are
exact, padded vocab logits are masked in the loss).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | encdec
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int = 0              # 0 => d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_groups: int = 1
    conv_width: int = 4
    # --- hybrid (RecurrentGemma / Griffin) ---
    window: int = 0                # sliding-window size (0 = full attention)
    rnn_width: int = 0
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    # --- encoder-decoder ---
    enc_layers: int = 0            # >0 => enc-dec; n_layers = decoder depth
    # --- modality frontend stub ---
    frontend: str = "none"         # none | vision | audio
    frontend_tokens: int = 0       # patches / frames provided by input_specs
    # --- execution knobs ---
    # sequences longer than this use blockwise (online-softmax) attention;
    # 0 forces blockwise everywhere.  Dense materializes [B,H,T,T] scores
    # (the dominant temp buffer at train_4k — see §Perf iteration 3).
    attn_dense_threshold: int = 8192
    # --- numerics / padding bookkeeping ---
    param_dtype: str = "bfloat16"
    vocab_real: int = 0            # original vocab before padding (0 = same)
    heads_real: int = 0            # original head count before padding

    # ------------------------------------------------------------------ props
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:       # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rnn_width_(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True iff decode state is O(1) or bounded (long_500k eligible)."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds for the (decoder) stack."""
        if self.family == "hybrid" and self.block_pattern:
            reps = -(-self.n_layers // len(self.block_pattern))
            return tuple((self.block_pattern * reps)[: self.n_layers])
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        if self.family == "moe":
            return ("moe",) * self.n_layers
        return ("attn",) * self.n_layers

    # ------------------------------------------------------------- TP padding
    def resolve_for_tp(self, tp: int) -> "ModelConfig":
        """Pad head counts / vocab to multiples of the TP degree.

        Zero-weight padded heads and masked padded logits keep the math
        exact; the flop overhead is reported by the roofline's
        MODEL_FLOPS / HLO_FLOPs ratio.
        """
        def pad_to(v: int, m: int) -> int:
            return -(-v // m) * m if v else v

        changes = {}
        if self.n_heads and self.n_heads % tp:
            changes["heads_real"] = self.heads_real or self.n_heads
            changes["n_heads"] = pad_to(self.n_heads, tp)
        if self.n_kv_heads and self.n_kv_heads % tp:
            # KV heads must divide TP: replicate each KV head up to the next
            # multiple of tp (GQA-exact — queries already repeat KV heads;
            # the replication is absorbed into the cache/weight layout).
            changes["n_kv_heads"] = pad_to(self.n_kv_heads, tp)
        if self.vocab % tp:
            changes["vocab_real"] = self.vocab_real or self.vocab
            changes["vocab"] = pad_to(self.vocab, tp)
        if not changes:
            return self
        if "n_heads" in changes and self.head_dim == 0:
            changes["head_dim"] = self.head_dim_   # freeze pre-pad head_dim
        return dataclasses.replace(self, **changes)

    @property
    def vocab_unpadded(self) -> int:
        return self.vocab_real or self.vocab

    # --------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim_
        H, KV = self.n_heads, self.n_kv_heads
        att = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.qkv_bias:
            att += (H + 2 * KV) * hd
        mlp = 3 * d * ff
        total = 0
        for kind in self.layer_kinds():
            if kind == "ssm":
                di, S, Hs = self.d_inner, self.ssm_state, self.ssm_heads
                G = self.ssm_groups
                in_proj = d * (2 * di + 2 * G * S + Hs)
                conv = (di + 2 * G * S) * self.conv_width
                total += in_proj + conv + 3 * Hs + di + di * d
            elif kind == "rec":
                r = self.rnn_width_
                total += 2 * d * r + 2 * r * r + r + r * d + 2 * d * ff + ff * d
            elif kind == "moe":
                total += att + d * self.n_experts \
                    + self.n_experts * 3 * d * ff
            else:
                total += att + mlp
            total += 2 * d                      # norms
        if self.is_encdec:
            # encoder stack (self-attn + mlp) + decoder cross-attn
            total += self.enc_layers * (att + mlp + 2 * d)
            total += self.n_layers * (att + d)
        total += V * d * 2                      # embed + unembed
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe" or not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_experts = self.n_experts * 3 * d * ff
        active_experts = self.top_k * 3 * d * ff
        per_layer_delta = dense_experts - active_experts
        return self.param_count() - self.n_layers * per_layer_delta
