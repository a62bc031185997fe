"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — small llama-arch.

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab 49152."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    head_dim=64, d_ff=1536, vocab_size=49152,
    rope_theta=10000.0, dtype="bfloat16")


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(num_layers=2, d_model=72, num_heads=3,
                         num_kv_heads=1, head_dim=24, d_ff=144,
                         vocab_size=256, dtype="float32", remat=False,
                         attn_impl="ref")
