"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8, head_dim=112) MoE 384 experts top-8 with
per-expert d_ff=2048, vocab 163840.  Assignment config exactly; K2's MLA
attention and shared expert are simplified to GQA / no-shared per the
assigned spec (noted in DESIGN.md §5).  ~1.03T total / ~32B active params.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    head_dim=112, d_ff=0, moe_d_ff=2048, num_experts=384,
    experts_per_token=8, vocab_size=163840,
    rope_theta=50000.0, dtype="bfloat16", capacity_factor=1.25)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(num_layers=2, d_model=64, num_heads=4,
                         num_kv_heads=2, head_dim=16, moe_d_ff=32,
                         num_experts=8, experts_per_token=2,
                         vocab_size=256, dtype="float32", remat=False,
                         attn_impl="ref")
