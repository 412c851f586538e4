"""glm-4.7-flash — GLM-4.7-Flash (``glm4_moe_lite``, 30B-A3B): MLA with 20
heads and a low-rank query, one dense layer, then 46 MoE layers of 64
routed experts top-4 and one shared expert, routed by sigmoid scores with
a per-expert correction bias [hf:zai-org/GLM-4.7-Flash config.json].

A port-only architecture (the JAX package has no such model). Its layer
equations are DeepSeek-V3's MLA and MoE at these widths: q = W_qb
RMSNorm(W_qa x) (``q_lora_rank`` 768), the latent cache of deepseek-v2
(``kv_lora_rank`` 512 + ``qk_rope_head_dim`` 64, FP8 with two scales a
token), values of 256 beside query heads of 192 + 64, and the router's
``noaux_tc`` choice: the top-4 of sigmoid(logits) + bias, weighted by the
unbiased scores renormalised and times 1.8. The one MTP layer is not run.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm-4.7-flash",
    family="mla",
    num_layers=47,
    d_model=2048,
    num_heads=20,
    num_kv_heads=20,         # MLA: all heads read the shared latent
    head_dim=192,            # = qk_nope_head_dim
    d_ff=10240,              # dense FFN (first layer)
    moe_d_ff=1536,           # per routed expert
    vocab_size=154880,
    num_experts=64,
    num_shared_experts=1,
    top_k=4,
    first_dense_layers=1,
    router_score="sigmoid",
    routed_scaling=1.8,
    kv_lora_rank=512,
    q_lora_rank=768,
    qk_nope_head_dim=192,
    qk_rope_head_dim=64,
    v_head_dim=256,
    rope_theta=1e6,
    source="hf:zai-org/GLM-4.7-Flash",
)
