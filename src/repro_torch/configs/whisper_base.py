"""Whisper-base [arXiv:2212.04356; unverified] — enc-dec, audio family.

6L encoder + 6L decoder, d_model=512 8H (MHA) d_ff=2048 vocab 51865.
The conv/log-mel frontend is a STUB: input_specs provides 1500 frame
embeddings.  Deviation: sinusoidal decoder positions instead of whisper's
learned 448-entry table (required to lower the assigned 32k decode cells).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, encoder_layers=6, encoder_seq=1500,
    d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    use_layernorm=True, use_gelu=True, tie_embeddings=True,
    dtype="bfloat16")


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(num_layers=2, encoder_layers=2, encoder_seq=16,
                         d_model=64, num_heads=4, num_kv_heads=4,
                         head_dim=16, d_ff=128, vocab_size=256,
                         dtype="float32", remat=False, attn_impl="ref")
