#!/usr/bin/env python3
"""The work of one item through each model of the zoo, reckoned from the
code: floating-point operations, weight bytes and activation traffic.

    python3 scripts/model_zoo_work.py [--batch 8]

Builds each configuration's modules on PyTorch's meta device (no memory,
no arithmetic), runs one forward at 256-px images (32x32 latents) under
``torch.utils.flop_counter.FlopCounterMode`` and a dispatch mode that
adds up the bytes of every ATen op's tensor inputs and outputs in bf16,
and prints per item: GFLOP, the weights' MB (read once a batch, shared
by ``--batch`` items) and the activation traffic in MB (what unfused ops
would move), with the least time an H100 SXM could take for a batch
(989 TFLOP/s bf16, 3.35 TB/s), the larger of the two.  The
configurations: the flagship ``vae_base`` U-Net, ``template_base``'s
U-Net (8 input channels), the ``vae_cin_ldm`` preset
(``configs/model_ldm.yaml``), the ``vae_guidedDiffusion`` preset
(``configs/model_adm.yaml``, heads of 64 channels), the SD-VAE encoder
and the ResNet-50 template encoder.
PoseUNet's K3 and K2 ops count through their plain versions (the same
arithmetic).  Runs on any host; the numbers are counts, not measurements.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BF16_TC_OPS, HBM_BPS = 989e12, 3.35e12


class ByteCounter(TorchDispatchMode):
    """Sum of the bf16 bytes of each op's tensor inputs and outputs, the
    parameters left out (counted once a batch apart); views move none."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = torch.utils._pytree.tree_leaves((args, kwargs, out))
        if func not in (torch.ops.aten.detach.default, torch.ops.aten.t.default, torch.ops.aten.view.default,
                        torch.ops.aten._unsafe_view.default, torch.ops.aten.permute.default,
                        torch.ops.aten.expand.default, torch.ops.aten.transpose.int):
            self.bytes += sum(2 * t.numel() for t in flat
                              if isinstance(t, torch.Tensor) and not isinstance(t, torch.nn.Parameter))
        return out


def configs():
    from nope_tpu_torch.configs import load_config

    yield "vae_base (flagship)", load_config(None).model
    yield "template_base", load_config(None, ["model.u_net.variant=template_base", "model.encoder.kind=template",
                                              "model.encoder.latent_dim=8"]).model
    yield "vae_cin_ldm", load_config(str(ROOT / "configs" / "model_ldm.yaml")).model
    yield "vae_guidedDiffusion", load_config(str(ROOT / "configs" / "model_adm.yaml")).model


def measure(fn, batch):
    flops, counter = FlopCounterMode(display=False), ByteCounter()
    with flops, counter:
        fn()
    return flops.get_total_flops() / batch, counter.bytes / batch


def report(name, module, fn, batch):
    flop, act = measure(fn, batch)
    weights = 2 * sum(p.numel() for p in module.parameters())
    t_ops = batch * flop / BF16_TC_OPS
    t_bytes = (batch * act + weights) / HBM_BPS
    print(f"{name:<34} {flop / 1e9:9.2f} GFLOP/item  weights {weights / 1e6:8.1f} MB  "
          f"activations {act / 1e6:9.1f} MB/item  bound at B={batch}: {1e3 * max(t_ops, t_bytes):8.3f} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'})", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=8)
    args = parser.parse_args()
    from nope_tpu_torch.models import blocks
    from nope_tpu_torch.models.factory import _encoder, _unet
    from nope_tpu_torch.ops import fused_resnet, linear_attention

    blocks.fused_resnet_block = fused_resnet.resnet_block_plain  # meta tensors: the plain arithmetic
    blocks.linear_attention = linear_attention.linear_attention_inner_plain
    b = args.batch
    print(f"per item at 256-px images, 32x32 latents; bf16 bytes; H100 SXM peaks (batch {b})")
    with torch.device("meta"):
        for name, cfg in configs():
            unet = _unet(cfg.u_net, cfg.encoder.latent_dim)
            x, pose = torch.zeros(b, cfg.encoder.latent_dim, 32, 32), torch.zeros(b, 6)
            report(f"U-Net {name}", unet, lambda: unet(x, pose), b)
        for name, cfg in list(configs())[:2]:
            enc = _encoder(cfg.encoder).to("meta")
            images = torch.zeros(b, 256, 256, 3)
            report(f"encoder {cfg.encoder.kind} ({name})", enc, lambda: enc.encode_image(images), b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
