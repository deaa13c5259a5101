"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216
— SigLIP + gemma backbone.  [arXiv:2407.07726; hf]

The SigLIP vision tower is a stub: a batch carries 256 precomputed patch
embeddings of width 1152 per image; the linear projection to d_model and
the gemma decoder are real.  (PaliGemma's bidirectional prefix attention is
simplified to causal, as in the reference.)"""

from ..models.model import ModelConfig

NUM_PATCHES = 256
PATCH_DIM = 1152


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        num_layers=18, d_model=2048, vocab_size=257216,
        num_heads=8, num_kv_heads=1, head_dim=256,
        d_ff=16384, mlp_activation="gelu",
        frontend="patches", frontend_dim=PATCH_DIM,
        num_frontend_tokens=NUM_PATCHES,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b-smoke", family="vlm",
        num_layers=2, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, mlp_activation="gelu",
        frontend="patches", frontend_dim=48, num_frontend_tokens=16,
        tie_embeddings=True, q_chunk=32, xent_chunk=32,
    )
