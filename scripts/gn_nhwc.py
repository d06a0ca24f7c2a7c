#!/usr/bin/env python3
"""The channels-last GroupNorm pair (``fused_resnet.group_norm_film_silu_nhwc``)
on the card, alone, and the LDM's and the ADM's bf16 forward with and
without it.  The one script that times the pair, in both dtypes.

    python3 scripts/gn_nhwc.py [--items N M] [--top K]

On one CUDA GPU, from the root of a checkout.  First ``chip_smoke.py``'s
phase-2 counts of the pair over one bf16 forward of the published ADM and
of the LDM, and of one float32 SD-VAE encode (whose routed convs it also
checks), and its checks (each distinct GroupNorm those ran, and each of
``chip_smoke.NHWC_NORM_SHAPES`` with the FiLM and with the addend, against
``F.group_norm`` in float32 and twice for a bitwise repeat); then its
phase-4 timings of the pair beside ATen's chain at each of their
GroupNorms (the VAE's at 64 images, also per image).  Last, a bf16 forward (no
gradient) of the ADM at N items and of the LDM at M (by default 1,984,
a full-protocol chunk of the evaluation sweep, and 832, half the LDM
cell's fast bank: the LDM's attention scores, heads x 1,024² an item,
outgrow what the ADM's run leaves of the card at 1,664), with the route
on and with it off
(``channels_last_norms_route`` answering False: the plain path), median
device time of 3 by CUDA events, and a ``torch.profiler`` breakdown of
the top K kernels of each.  TF32 is off, as in every chip number of the
port.
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nope_tpu_torch.models.adm_unet import ADMPoseUNet  # noqa: E402
from nope_tpu_torch.models.ldm_unet import LDMPoseUNet  # noqa: E402
from nope_tpu_torch.models.vae import StableDiffusionVAE  # noqa: E402
from nope_tpu_torch.ops import fused_resnet as fr  # noqa: E402


def forwards(items: dict, top: int, dev: torch.device) -> None:
    """Each model's bf16 forward at its ``items`` with the route on and off."""
    route = fr.channels_last_norms_route
    for name, cls in (("vae_guidedDiffusion", ADMPoseUNet), ("vae_cin_ldm", LDMPoseUNet)):
        n = items[name]
        torch.manual_seed(11)
        with torch.device(dev):
            net = cls()
        chip_smoke.noise_zero_layers(torch, net, 12)
        half = copy.deepcopy(net).to(torch.bfloat16).requires_grad_(False)
        del net
        gen = torch.Generator(device=dev).manual_seed(13)
        x = torch.randn(n, 4, chip_smoke.LATENT, chip_smoke.LATENT, generator=gen, device=dev).to(torch.bfloat16)
        pose = torch.randn(n, half.rot_representation_dim, generator=gen, device=dev).to(torch.bfloat16)
        times = {}
        try:
            with torch.no_grad():
                for side in ("on", "off", "off", "on"):
                    fr.channels_last_norms_route = route if side == "on" else (lambda *args: False)
                    times.setdefault(side, []).append(chip_smoke.median_ms(torch, lambda: half(x, pose)))
                for side in ("on", "off"):
                    fr.channels_last_norms_route = route if side == "on" else (lambda *args: False)
                    chip_smoke.profile_window(torch, f"{name} bf16 forward B={n} route {side}",
                                              lambda: half(x, pose), top=top)
        finally:
            fr.channels_last_norms_route = route
        on, off = min(times["on"]), min(times["off"])
        print(f"  {name} bf16 forward B={n}: route on {on:.3f} ms, off {off:.3f} ms ({off / on:.3f}x; "
              f"each side the better of two medians of 3, in turns on, off, off, on)")
        del half, x, pose
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--items", type=int, nargs=2, default=(chip_smoke.EVAL_ITEMS[0], 32 * chip_smoke.FAST_N),
                        help="U-Net items of the ADM's and of the LDM's forward")
    parser.add_argument("--top", type=int, default=12, help="kernels the profiles list")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gn_nhwc: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    def check(kernel, label, got, want, dtype_name):
        err, rel = chip_smoke.rel_err(got, want)
        tol = chip_smoke.TOL[dtype_name][kernel]
        ok = rel <= tol and torch.isfinite(got.float()).all().item()
        print(f"  {kernel} {label:<44} {dtype_name:<8} max_abs {err:.3e} rel {rel:.3e} tol {tol:.0e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{kernel} {label} {dtype_name} disagrees with its plain version")

    print("checks (chip_smoke.py phase 2):")
    seen = chip_smoke.nhwc_norm_counts(torch, fr, dev)
    torch.manual_seed(0)
    vae = StableDiffusionVAE().to(dev).eval()
    seen["sd_vae_float32"] = chip_smoke.vae_route_checks(torch, F, fr, dev, vae, check)[1]
    del vae
    n = chip_smoke.nhwc_norm_checks(torch, F, fr, dev, check, seen)
    print(f"  two launches bitwise equal at all {n} shapes")
    print("timings (chip_smoke.py phase 4; device alone):")
    chip_smoke.nhwc_norm_timings(torch, F, fr, dev, seen)
    print("forwards (CUDA events; TF32 off):")
    forwards(dict(zip(("vae_guidedDiffusion", "vae_cin_ldm"), args.items)), args.top, dev)
    print("gn_nhwc: done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
