"""The five LM architectures, exact configs from their public sources (the
JAX package's ``repro.configs.lm_archs``, field for field)."""
from __future__ import annotations

import torch

from ..models.transformer import MoEConfig, TransformerConfig
from ..optim.adamw import AdamWConfig
from .lm_family import make_lm_arch

# codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B]: 32L d4096 32H (GQA kv=32 = MHA)
# d_ff=13440 vocab=92416, QKV bias (qwen1.5 arch)
CODEQWEN15_7B = make_lm_arch(
    "codeqwen1.5-7b",
    TransformerConfig(
        "codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=13440, vocab=92416, d_head=128, qkv_bias=True, rope_theta=1_000_000.0,
    ),
)

# qwen2.5-3b [hf]: 36L d2048 16H (GQA kv=2) d_ff=11008 vocab=151936, QKV bias
QWEN25_3B = make_lm_arch(
    "qwen2.5-3b",
    TransformerConfig(
        "qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        d_ff=11008, vocab=151936, d_head=128, qkv_bias=True, rope_theta=1_000_000.0,
        tie_embeddings=True,
    ),
)

# llama3-8b [arXiv:2407.21783]: 32L d4096 32H (GQA kv=8) d_ff=14336 vocab=128256
LLAMA3_8B = make_lm_arch(
    "llama3-8b",
    TransformerConfig(
        "llama3-8b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256, d_head=128, rope_theta=500_000.0,
    ),
)

# arctic-480b [hf:Snowflake/snowflake-arctic-base]: 35L d7168 56H (GQA kv=8)
# dense-residual d_ff=4864 ∥ MoE 128e top-2. Optimizer state: bf16 moments +
# bf16 params, halving the state's bytes while keeping the param-tree layout.
ARCTIC_480B = make_lm_arch(
    "arctic-480b",
    TransformerConfig(
        "arctic-480b", n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=4864, vocab=32000, d_head=128, param_dtype=torch.bfloat16,
        moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True),
    ),
    opt=AdamWConfig(lr=1e-4, moment_dtype=torch.bfloat16),
)

# olmoe-1b-7b [arXiv:2409.02060]: 16L d2048 16H (kv=16) MoE 64e top-8 d_ff=1024
OLMOE_1B_7B = make_lm_arch(
    "olmoe-1b-7b",
    TransformerConfig(
        "olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304, d_head=128,
        moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024, dense_residual=False),
    ),
)
