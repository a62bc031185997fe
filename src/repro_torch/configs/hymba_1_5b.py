"""Hymba-1.5B [arXiv:2411.13676; hf] — hybrid parallel attn+SSM heads.

32L d_model=1600 25H (GQA kv=5) d_ff=5504 ssm_state=16 vocab 32001.
Sliding-window attention (1024) everywhere except 3 global layers
(first / middle / last, per the Hymba paper) — this is what makes the
long_500k decode cell feasible: only 3 layers keep a full-length KV cache.
Meta-tokens are omitted (assignment spec lists none).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    head_dim=64, d_ff=5504, vocab_size=32001,
    ssm_state=16, ssm_expand=1, window=1024, global_layers=(0, 15, 31),
    ssm_chunk=128,
    rope_theta=10000.0, dtype="bfloat16")


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(num_layers=3, d_model=80, num_heads=5,
                         num_kv_heads=1, head_dim=16, d_ff=160,
                         ssm_state=8, window=8, global_layers=(1,),
                         ssm_chunk=8, vocab_size=256, dtype="float32",
                         remat=False, attn_impl="ref")
