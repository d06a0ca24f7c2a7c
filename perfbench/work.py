"""The yardstick's arithmetic: the H100's published peaks, the model
FLOPs a forward takes, and the operations and bytes of the K3 and K2
modules from their input shapes.

``k3_work`` and ``bound`` are frozen copies of ``chip_smoke.py``'s;
``model_flops`` counts as ``scripts/model_zoo_work.py`` does, with
``torch.utils.flop_counter`` over a forward on the meta device.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

#: NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 CUDA
#: cores, TF32 tensor cores, HBM3 bytes/s
BF16_TC_OPS, F32_OPS, TF32_TC_OPS, HBM_BPS = 989e12, 67e12, 495e12, 3.35e12


def k3_work(shape, batch):
    """(tensor-core operations, float32 operations, bytes) of one K3 block
    in bf16, ``shape`` = (h, w, cin, co, res, emb): its three convs,
    counting only the products by an input inside the image (a
    zero-padded 3x3 conv over H x W has (3H-2)(3W-2) such (pixel, tap)
    pairs of its 9HW); the two GroupNorm+SiLU passes (~12 operations an
    element with their statistics) and the residual add; x, weights, emb
    and parameters read once and the output written once."""
    h, w, cin, co, res, emb = shape[:6]
    m = batch * h * w
    taps = batch * (3 * h - 2) * (3 * w - 2)
    macs = taps * (cin + co) * co + (m * cin * co if res else 0)
    k = 9 * cin + 9 * co + (cin if res else 0)
    nbytes = 2 * (m * cin + m * co + k * co + (batch * co if emb else 0) + 8 * co)
    return 2.0 * macs, 25.0 * m * co, float(nbytes)


def k2_work(dim, hw, batch, heads=4, dim_head=32):
    """(tensor-core operations, float32 operations, bytes) of one
    LinearAttention module in bf16 over ``batch`` items of ``hw`` tokens of
    ``dim`` channels: the qkv and output 1x1 convs and the two
    (d x d) products of each head, the two softmaxes (~5 operations an
    element) and the output GroupNorm (~8); x and the weights read once,
    the output written once."""
    m, hidden = batch * hw, heads * dim_head
    tc = 2.0 * m * dim * 3 * hidden + 4.0 * m * hidden * dim_head + 2.0 * m * hidden * dim
    f32 = 10.0 * m * hidden + 8.0 * m * dim
    nbytes = 2.0 * (2 * m * dim + 4 * hidden * dim + 3 * dim)
    return tc, f32, nbytes


def bound(tc_ops=0.0, f32_ops=0.0, nbytes=0.0, tf32_ops=0.0):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the largest of the tensor cores' (bf16 or TF32), the CUDA cores' and
    the memory's times, which can all run at once."""
    ops_ms = 1e3 * max(tc_ops / BF16_TC_OPS, f32_ops / F32_OPS, tf32_ops / TF32_TC_OPS)
    bytes_ms = 1e3 * nbytes / HBM_BPS
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def model_flops(fn) -> float:
    """The FLOPs ``fn`` (a forward over meta tensors) counts."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


def unet_flops_per_item(unet, latent_channels, latent_hw, pose_dim=6, batch=2) -> float:
    """FLOPs of one U-Net item (``unet`` on the meta device)."""
    x = torch.zeros(batch, latent_channels, latent_hw, latent_hw, device="meta")
    pose = torch.zeros(batch, pose_dim, device="meta")
    return model_flops(lambda: unet(x, pose)) / batch


def encode_flops_per_image(vae, img_size, batch=2) -> float:
    """FLOPs of one VAE encode (``vae`` on the meta device)."""
    images = torch.zeros(batch, img_size, img_size, 3, device="meta")
    return model_flops(lambda: vae.encode_image(images)) / batch
