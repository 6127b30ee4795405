"""The fine level after the Blender ``train_crop`` warm-up, on the card.

    python -m nerfsr_torch.warmup_lag

Writes an 800x800 Blender scene of the blob field (``data/synthetic.py``:
8 train, 2 val and 2 test views) into a temporary directory and trains
vanilla NeRF on it at 200x200 with the flags of
``scripts/train_blender.sh`` (parity 64 + 64 samples, 2048 rays a step,
the LR held at 5e-4) for 1100 steps, three times from one seed: through
the kernels in mixed precision after the 1000-step warm-up of
``python -m nerfsr_torch.train_blender``, through the plain PyTorch
versions in f32 after it, and through the kernels without it. After
each run it prints, from that run's route: the validation PSNR of both
levels, and for each level on val view 0 (rendered without jitter) its
MSE, mean opacity and mean depth, and its MSE on a fixed batch of 2048
rays of the training views. Every 100 steps it prints the step's
training MSE of both levels. The card's name and power limit come
first. Needs a CUDA card.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

# name: (precision, warm-up, plain versions)
RUNS = {"warm_kernels": ("mixed", True, False),
        "warm_plain": ("f32", True, True),
        "cold_kernels": ("mixed", False, False)}
STEPS = 1100
LEVELS = ("coarse", "fine")


def _upload(buf, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in buf.items()}


@torch.no_grad()
def _report(name, opt, system, params, dev):
    from nerfsr_torch.data import create_dataset
    from nerfsr_torch.engine import validate

    val = create_dataset(opt, "val")
    m = validate(opt, system, params, val)
    print(f"[lag] {name}: validation coarse {m['coarse_psnr']:.2f} dB, "
          f"fine {m['fine_psnr']:.2f} dB")
    view = val.image_rays(0)
    rays = _upload({k: view[k] for k in ("origins", "directions", "near",
                                         "far")}, dev)
    parts = {}
    for i in range(0, len(rays["origins"]), 4096):
        out = system.render(params, system._batch_to_rays(
            {k: v[i:i + 4096] for k, v in rays.items()}), randomized=False)
        for lvl in LEVELS:
            for key in ("rgb", "opacity", "depth"):
                parts.setdefault(f"{lvl}_{key}", []).append(
                    out[f"{lvl}_{key}"].float())
    out = {k: torch.cat(v) for k, v in parts.items()}
    gt = torch.from_numpy(view["rgbs"]).to(dev)
    buf = create_dataset(opt, "train").ray_buffer()
    rows = np.arange(2048) * (len(buf["rgbs"]) // 2048)
    opt.randomized = False
    _, losses = system._loss_fn(params, _upload(
        {k: v[rows] for k, v in buf.items()}, dev))
    for lvl in LEVELS:
        mse = torch.mean((out[f"{lvl}_rgb"] - gt) ** 2)
        print(f"[lag] {name} {lvl}: val view 0 MSE {float(mse):.5f}, mean "
              f"opacity {float(out[f'{lvl}_opacity'].mean()):.3f}, mean "
              f"depth {float(out[f'{lvl}_depth'].mean()):.3f}; training "
              f"views MSE {float(losses[f'{lvl}_mse']):.5f}")


def main():
    from nerfsr_torch.config import parse_options
    from nerfsr_torch.data import create_dataset
    from nerfsr_torch.data.synthetic import write_blender_scene
    from nerfsr_torch.models import create_model
    from nerfsr_torch.train_blender import WARMUP_ITERS

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[card] {card}")
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="nerfsr_lag_") as work:
        scene = os.path.join(work, "scene")
        write_blender_scene(scene, hw=(800, 800), n_train=8, n_val=2,
                            n_test=2, device=dev)
        for name, (precision, warm, plain) in RUNS.items():
            opt = parse_options("train", [
                "--name", name, "--model", "nerf", "--dataset_mode",
                "blender", "--dataset_root", scene, "--img_wh", "200", "200",
                "--N_coarse", "64", "--N_importance", "64",
                "--sigma_activation", "relu", "--batch_size", "2048",
                "--precision", precision, "--lr", "5e-4",
                "--n_epochs_decay", "0"])
            system = create_model(opt, device=dev)
            if plain:
                system.render_cfg = dataclasses.replace(system.render_cfg,
                                                        plain=True)
            state = system.create_state(seed=opt.seed, steps_per_epoch=100)
            full = _upload(create_dataset(opt, "train").ray_buffer(), dev)
            crop = _upload(create_dataset(opt, "train_crop").ray_buffer(),
                           dev) if warm else full
            gen = torch.Generator(device=dev).manual_seed(opt.seed)
            t0 = time.perf_counter()
            for step in range(STEPS):
                state, losses = system.train_step_from_buffer(
                    state, crop if step < WARMUP_ITERS else full, gen)
                if (step + 1) % 100 == 0:
                    mses = ", ".join(f"{lvl} {float(losses[lvl + '_mse']):.5f}"
                                     for lvl in LEVELS)
                    print(f"[lag] {name} step {step + 1}: training MSE {mses}")
            torch.cuda.synchronize()
            print(f"[lag] {name}: {STEPS} steps in "
                  f"{time.perf_counter() - t0:.1f} s on {card}")
            _report(name, opt, system, state.params, dev)


if __name__ == "__main__":
    main()
