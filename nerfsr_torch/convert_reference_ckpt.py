"""Convert the PyTorch NeRF-SR reference's checkpoints into the port's.

    python -m nerfsr_torch.convert_reference_ckpt <ref_ckpt_dir> <epoch> \\
        <out_checkpoints_dir> <name> [--model nerf|nerf_downX] \\
        [--D 8 --W 256 --deg_pos 10 --deg_dir 4]

Port of ``tools/convert_reference_ckpt.py``, which needs JAX; this one
runs wherever torch does. The reference saves one state dict per network
as ``{epoch}_net_{Coarse,Fine}.pth``; its VanillaMLP's layers map one to
one onto the port's (torch ``Linear`` weights are (out, in) in both, and
the checkpoint stores flax's (in, out) kernels)::

    xyz_encoding_{i}.0.{weight,bias} -> xyz_encoding_{i}
    xyz_encoding_final.{weight,bias} -> xyz_encoding_final
    dir_encoding.0.{weight,bias}     -> dir_encoding
    sigma.{weight,bias}              -> sigma
    rgb.0.{weight,bias}              -> rgb

A leading ``module.`` (DataParallel) is stripped. Adam starts fresh (the
reference saves no moments). It writes ``{epoch}_state.msgpack`` and
``latest_state.msgpack`` under ``<out_checkpoints_dir>/<name>/``, which
``--continue_train --load_epoch <epoch>`` and ``python -m
nerfsr_torch.test --load_epoch <epoch>`` read (and the JAX package too).
"""

from __future__ import annotations

import argparse
import os

import torch

from nerfsr_torch.config import default_options
from nerfsr_torch.models import create_model
from nerfsr_torch.utils import checkpoint as ckpt
from nerfsr_torch.weights import load_jax_params


def reference_state_to_flax(state_dict, depth: int = 8) -> dict:
    """A reference VanillaMLP state dict of tensors -> flax variables
    ``{"params": {layer: {"kernel" (in, out), "bias"}}}`` of numpy
    arrays."""
    sd = {}
    for k, v in state_dict.items():
        key = k[len("module."):] if k.startswith("module.") else k
        sd[key] = v.detach().cpu().float().numpy()

    def lin(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T.copy(),
                "bias": sd[f"{prefix}.bias"].copy()}

    params = {f"xyz_encoding_{i + 1}": lin(f"xyz_encoding_{i + 1}.0")
              for i in range(depth)}
    params["xyz_encoding_final"] = lin("xyz_encoding_final")
    params["sigma"] = lin("sigma")
    params["dir_encoding"] = lin("dir_encoding.0")
    params["rgb"] = lin("rgb.0")
    return {"params": params}


def convert(ref_dir: str, epoch: int, out_dir: str, name: str,
            model: str = "nerf", D: int = 8, W: int = 256,
            deg_pos: int = 10, deg_dir: int = 4) -> str:
    """Convert epoch ``epoch`` of ``ref_dir``; returns the written path."""
    opt = default_options(
        "train", name=name, model=model,
        dataset_mode="llff" if model == "nerf" else "llff_downX",
        D=D, W=W, deg_pos=deg_pos, deg_dir=deg_dir,
        checkpoints_dir=out_dir, device="cpu")
    system = create_model(opt, device="cpu")
    state = system.create_state(seed=0, steps_per_epoch=1)
    tree = {}
    for level, net in (("coarse", "Coarse"), ("fine", "Fine")):
        path = os.path.join(ref_dir, f"{epoch}_net_{net}.pth")
        tree[level] = reference_state_to_flax(
            torch.load(path, map_location="cpu"), depth=D)
        print(f"[convert] {path} -> params['{level}']")
    load_jax_params(state.params, tree)
    out = ckpt.save_checkpoint(opt, state, epoch)
    print(f"[convert] wrote {out}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ref_dir", help="the reference's checkpoints/{name} dir")
    p.add_argument("epoch", type=int)
    p.add_argument("out_dir", help="the port's --checkpoints_dir")
    p.add_argument("name", help="the port's --name (subdirectory)")
    p.add_argument("--model", default="nerf", choices=["nerf", "nerf_downX"])
    p.add_argument("--D", type=int, default=8)
    p.add_argument("--W", type=int, default=256)
    p.add_argument("--deg_pos", type=int, default=10)
    p.add_argument("--deg_dir", type=int, default=4)
    a = p.parse_args(argv)
    return convert(a.ref_dir, a.epoch, a.out_dir, a.name, a.model, a.D, a.W,
                   a.deg_pos, a.deg_dir)


if __name__ == "__main__":
    main()
