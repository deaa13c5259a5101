"""h2o-danube-3-4b [dense]: 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000, llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; unverified]"""

from ..models.model import ModelConfig

SLIDING_WINDOW = 4096


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        num_layers=24, d_model=3840, vocab_size=32000,
        num_heads=32, num_kv_heads=8, head_dim=120,
        sliding_window=SLIDING_WINDOW,
        d_ff=10240, tie_embeddings=False,
        # SWA bounds the decode cache to the window -> long_500k applies.
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-smoke", family="dense",
        num_layers=2, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16,
        sliding_window=64,
        d_ff=128, tie_embeddings=False, q_chunk=32, xent_chunk=32,
        supports_long_context=True,
    )
