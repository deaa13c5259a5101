"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936,
qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""

from ..models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        num_layers=36, d_model=4096, vocab_size=151936,
        num_heads=32, num_kv_heads=8, head_dim=128, qk_norm=True,
        rope_theta=1_000_000.0,
        d_ff=12288, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-smoke", family="dense",
        num_layers=2, d_model=96, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=24, qk_norm=True,
        d_ff=192, tie_embeddings=False, q_chunk=32, xent_chunk=32,
    )
