"""mamba2-1.3b [ssm]: 48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]"""

from ..models.model import ModelConfig
from ..models.ssm import SSMConfig


def config() -> ModelConfig:
    d = 2048
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        num_layers=48, d_model=d, vocab_size=50280,
        ssm=SSMConfig(d_model=d, d_inner=2 * d, headdim=64, d_state=128),
        tie_embeddings=True,
        supports_long_context=True,
    )


def smoke_config() -> ModelConfig:
    d = 64
    return ModelConfig(
        name="mamba2-1.3b-smoke", family="ssm",
        num_layers=2, d_model=d, vocab_size=256,
        ssm=SSMConfig(d_model=d, d_inner=2 * d, headdim=32, d_state=16, chunk=32),
        tie_embeddings=True, xent_chunk=32,
        supports_long_context=True,
    )
