"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B family; hf]"""

from ..models.model import ModelConfig
from ..models.moe import MoEConfig


def config() -> ModelConfig:
    d = 4096
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        num_layers=94, d_model=d, vocab_size=151936,
        num_heads=64, num_kv_heads=4, head_dim=128, qk_norm=True,
        rope_theta=1_000_000.0,
        d_ff=1536,
        moe=MoEConfig(d_model=d, d_ff=1536, num_experts=128, top_k=8),
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    d = 64
    return ModelConfig(
        name="qwen3-moe-235b-a22b-smoke", family="moe",
        num_layers=2, d_model=d, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, qk_norm=True,
        d_ff=96,
        moe=MoEConfig(d_model=d, d_ff=96, num_experts=8, top_k=4, group_size=32),
        tie_embeddings=False, q_chunk=32, xent_chunk=32,
    )
