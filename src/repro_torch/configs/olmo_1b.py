"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304,
non-parametric LN.  [arXiv:2402.00838; hf]"""

from ..models.model import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", family="dense",
        num_layers=16, d_model=2048, vocab_size=50304,
        num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=8192, norm="nonparametric", tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b-smoke", family="dense",
        num_layers=2, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, norm="nonparametric", tie_embeddings=True,
        q_chunk=32, xent_chunk=32,
    )
