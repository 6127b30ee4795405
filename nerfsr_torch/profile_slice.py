"""Where the time of a slice goes on the card.

    python -m nerfsr_torch.profile_slice [--views 2] [--top 15]
    python -m nerfsr_torch.profile_slice --train [--steps 10] [--top 25]

Serving (default): renders 504x378 NeRF-SR x2 views (``--fast_preset
llff``, mixed precision, full-width MLP, random weights from a seed)
through ``render_eval_many`` after one warm-up view. ``--train``: trains
a seed-0 student on a teacher scene the port renders itself (2 views,
``--batch_size 512`` LR pixels, 2048 HR rays a step) for ``--steps``
steps after 3 warm-up steps. Both run under ``torch.profiler`` and print
the device time by kernel name, the device time per image or step, the
wall time per image or step and the device's busy share (device time /
wall time). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

HR_WH = (504, 378)
FOCAL = 407.0


def _options(phase, **extra):
    from nerfsr_torch.config import default_options
    return default_options(phase, model="nerf_downX",
                           dataset_mode="llff_downX", fast_preset="llff",
                           img_wh=HR_WH, downscale=2, precision="mixed",
                           **extra)


def _serving(args):
    """(run, units, unit name): render ``--views`` views."""
    from nerfsr_torch.data.views import LLFFDownXViews
    from nerfsr_torch.models import create_model

    system = create_model(_options("test"), device="cuda")
    params = system.init_params(seed=0)
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, args.views + 1)
    list(system.render_eval_many(params, views, [0], quantize_rgb=True))

    def run():
        list(system.render_eval_many(params, views,
                                     range(1, args.views + 1),
                                     quantize_rgb=True))
    return run, args.views, "image"


def _training(args):
    """(run, units, unit name): ``--steps`` training steps."""
    from nerfsr_torch.data.views import LLFFDownXTrainViews
    from nerfsr_torch.models import create_model

    system = create_model(_options("train", batch_size=512, n_epochs=30,
                                   include_var=True, ds_method="avg"),
                          device="cuda")
    teacher = system.init_params(seed=1)
    with torch.no_grad():
        for net in teacher.values():
            net.sigma.bias += 3.0
    buffer = LLFFDownXTrainViews.rendered(system, teacher, FOCAL, HR_WH, 2,
                                          2).ray_buffer("cuda")
    state = system.create_state(seed=0, steps_per_epoch=buffer["rgbs"]
                                .shape[0] // 512)
    gen = torch.Generator(device="cuda").manual_seed(0)
    system.train_steps(state, buffer, 3, gen)

    def run():
        system.train_steps(state, buffer, args.steps, gen)
    return run, args.steps, "step"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="profile training steps instead of serving")
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    run, units, unit = (_training if args.train else _serving)(args)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # kernels only: a user annotation (e.g. Optimizer.step) spans the
    # kernels it encloses, gaps included, and would count them twice
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_us = sum(e.device_time_total for e in events)
    print(f"card: {card}")
    print(f"{unit}s {units}: wall {wall / units * 1e3:.1f} ms/{unit} "
          f"(under the profiler), device {device_us / units / 1e3:.2f} "
          f"ms/{unit}, busy share {device_us / 1e6 / wall:.3f}")
    print(f"{'device ms/' + unit:>16} {'calls/' + unit:>12}  kernel")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:args.top]:
        print(f"{e.device_time_total / units / 1e3:16.3f} "
              f"{e.count / units:12.1f}  {e.key[:90]}")


if __name__ == "__main__":
    main()
