"""musicgen-medium [audio]: 48L d_model=1536 24H (GQA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

The EnCodec frontend is a stub: a batch carries precomputed frame
embeddings (the sum of the 4 codebook embeddings, delay pattern applied
upstream); the decoder and the 4 per-codebook LM heads are real."""

from ..models.model import ModelConfig

NUM_CODEBOOKS = 4


def config() -> ModelConfig:
    d = 1536
    return ModelConfig(
        name="musicgen-medium", family="audio",
        num_layers=48, d_model=d, vocab_size=2048,
        num_heads=24, num_kv_heads=24, head_dim=64,
        d_ff=6144,
        frontend="frames", frontend_dim=d,
        num_lm_heads=NUM_CODEBOOKS,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    d = 64
    return ModelConfig(
        name="musicgen-medium-smoke", family="audio",
        num_layers=2, d_model=d, vocab_size=128,
        num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128,
        frontend="frames", frontend_dim=d,
        num_lm_heads=NUM_CODEBOOKS,
        tie_embeddings=False, q_chunk=32, xent_chunk=32,
    )
