"""DeepSeek 67B [arXiv:2401.02954; hf] — llama-arch.

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab 102400."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=22016, vocab_size=102400,
    rope_theta=10000.0, dtype="bfloat16")


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(num_layers=3, d_model=64, num_heads=4,
                         num_kv_heads=2, head_dim=16, d_ff=160,
                         vocab_size=256, dtype="float32", remat=False,
                         attn_impl="ref")
