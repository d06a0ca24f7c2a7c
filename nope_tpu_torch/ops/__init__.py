"""Ops with a hand-written CUDA kernel beside a plain PyTorch version.

- K1 :func:`similarity.reference_similarity` — the retrieval score;
- K2 :func:`linear_attention.linear_attention_inner` — linear attention's inner chain;
- K3 :func:`fused_resnet.resnet_block` — the U-Net's ResnetBlock.

Each runs its kernel for a CUDA tensor and its plain version for a CPU
tensor, and counts its kernel launches in a ``launches`` attribute.
K2 and K3 take gradients through :func:`linear_attention.linear_attention`
and :func:`fused_resnet.fused_resnet_block`, whose backward recomputes
the plain version.
"""
