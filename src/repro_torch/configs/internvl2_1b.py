"""InternVL2-1B [arXiv:2404.16821; hf] — InternViT frontend + Qwen2-0.5B LM.

LM backbone: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab 151655.
The InternViT vision tower is a STUB per the assignment: input_specs
provides 256 pre-computed patch embeddings which are linearly projected
and prepended to the text tokens."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    head_dim=64, d_ff=4864, vocab_size=151655, num_patches=256,
    rope_theta=1000000.0, dtype="bfloat16")


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(num_layers=2, d_model=56, num_heads=2,
                         num_kv_heads=1, head_dim=28, d_ff=112,
                         vocab_size=256, num_patches=4, dtype="float32",
                         remat=False, attn_impl="ref")
