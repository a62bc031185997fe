"""AI21-Jamba2-Mini [hf:ai21labs/AI21-Jamba2-Mini, config.json;
arXiv:2403.19887] — a hybrid of GQA attention and Mamba-1 layers with
16-expert MoE feed-forwards.

32L d_model=4096, one attention layer in 8 (``attn_layer_period`` 8,
``attn_layer_offset`` 4: 32 query heads, 8 KV heads, head dim 128, no
positional encoding), the other seven the published Mamba-1 mixer
(``mamba_d_state`` 16, ``mamba_expand`` 2, ``mamba_dt_rank`` 256,
``mamba_d_conv`` 4 with a conv bias, no projection bias, RMSNorms on dt,
B and C); a 16-expert top-2 MoE (expert width 14,336, SwiGLU, softmax
gates kept as they are) on every other layer (``expert_layer_period`` 2,
``expert_layer_offset`` 1), a dense MLP of the same width elsewhere.
Vocab 65,536, untied head, ``num_logits_to_keep`` 1, RMSNorm eps 1e-6.
Layer i is attention where i % 8 == 4 and MoE where i % 2 == 1, as the
published ``modeling_jamba.py`` derives them from those keys.

This is not one of the ten assigned architectures (``ARCH_IDS``): the
registry holds it beside them for ``launch.serve --model-smoke --arch
jamba2-mini``.
"""
from repro_torch.models.common import JambaConfig

CONFIG = JambaConfig(
    name="jamba2-mini", family="jamba",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, moe_d_ff=14336, num_experts=16,
    experts_per_token=2, vocab_size=65536,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_dt_rank=256,
    ssm_conv_bias=True, attn_layer_period=8, attn_layer_offset=4,
    expert_layer_period=2, expert_layer_offset=1, logits_to_keep=1,
    tie_embeddings=False, norm_eps=1e-6, dtype="bfloat16", remat=False)


def smoke_config() -> JambaConfig:
    """One whole period at tiny widths, float32: every layer kind, the
    pattern kept."""
    return CONFIG.scaled(num_layers=8, d_model=64, num_heads=4,
                         num_kv_heads=2, head_dim=16, d_ff=96, moe_d_ff=48,
                         num_experts=4, ssm_state=8, ssm_dt_rank=8,
                         vocab_size=256, dtype="float32", attn_impl="ref")
