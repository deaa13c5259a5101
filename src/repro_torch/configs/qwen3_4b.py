"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936,
qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""

from ..models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b", family="dense",
        num_layers=36, d_model=2560, vocab_size=151936,
        num_heads=32, num_kv_heads=8, head_dim=128, qk_norm=True,
        rope_theta=1_000_000.0,
        d_ff=9728, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b-smoke", family="dense",
        num_layers=2, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, qk_norm=True,
        d_ff=128, tie_embeddings=True, q_chunk=32, xent_chunk=32,
    )
