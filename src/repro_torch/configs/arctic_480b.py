"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""

from ..models.model import ModelConfig
from ..models.moe import MoEConfig


def config() -> ModelConfig:
    d = 7168
    return ModelConfig(
        name="arctic-480b", family="moe",
        num_layers=35, d_model=d, vocab_size=32000,
        num_heads=56, num_kv_heads=8, head_dim=128,
        d_ff=4864, dense_residual=True,
        moe=MoEConfig(d_model=d, d_ff=4864, num_experts=128, top_k=2),
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    d = 64
    return ModelConfig(
        name="arctic-480b-smoke", family="moe",
        num_layers=2, d_model=d, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=96, dense_residual=True,
        moe=MoEConfig(d_model=d, d_ff=96, num_experts=8, top_k=2, group_size=32),
        tie_embeddings=False, q_chunk=32, xent_chunk=32,
    )
