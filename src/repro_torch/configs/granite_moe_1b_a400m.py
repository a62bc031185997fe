"""IBM Granite 3.0 1b-a400m base [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) MoE 32 experts top-8, per-expert
d_ff=512, vocab 49155."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    head_dim=64, d_ff=0, moe_d_ff=512, num_experts=32,
    experts_per_token=8, vocab_size=49155,
    rope_theta=10000.0, dtype="bfloat16", capacity_factor=1.25)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(num_layers=2, d_model=64, num_heads=4,
                         num_kv_heads=2, head_dim=16, moe_d_ff=32,
                         num_experts=4, experts_per_token=2,
                         vocab_size=256, dtype="float32", remat=False,
                         attn_impl="ref")
