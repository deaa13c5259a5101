"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 + shared attn blocks.
[arXiv:2411.15242; hf]

The single shared transformer block (attention + MLP, one weight copy) is
applied every 6 Mamba2 layers; per-invocation LoRA adapters of the HF release
are omitted, as in the reference."""

from ..models.model import ModelConfig
from ..models.ssm import SSMConfig


def config() -> ModelConfig:
    d = 2560
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        num_layers=54, d_model=d, vocab_size=32000,
        num_heads=32, num_kv_heads=32, head_dim=80,
        d_ff=10240, hybrid_attn_every=6,
        ssm=SSMConfig(d_model=d, d_inner=2 * d, headdim=64, d_state=64),
        tie_embeddings=True,
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    d = 64
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid",
        num_layers=4, d_model=d, vocab_size=256,
        num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, hybrid_attn_every=2,
        ssm=SSMConfig(d_model=d, d_inner=2 * d, headdim=32, d_state=16, chunk=32),
        tie_embeddings=True, q_chunk=32, xent_chunk=32,
        supports_long_context=True,
    )
