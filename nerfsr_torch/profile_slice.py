"""Where the time of a slice goes on the card.

    python -m nerfsr_torch.profile_slice [--views 2] [--top 15]
    python -m nerfsr_torch.profile_slice --train [--steps 10] [--top 25]
    python -m nerfsr_torch.profile_slice --train --preset parity
    python -m nerfsr_torch.profile_slice --refine [--refine_network
        maxpoolingmodel | --refine_as_gan]
    python -m nerfsr_torch.profile_slice --train --eager [--host_top 30]

Serving (default): renders 504x378 NeRF-SR x2 views (``--fast_preset
llff``, or ``parity`` with ``--preset``; mixed precision, full-width
MLP, random weights from a seed)
through ``render_eval_many`` after one warm-up view. ``--train``: trains
a seed-0 student on a teacher scene the port renders itself (2 views,
``--batch_size 512`` LR pixels, 2048 HR rays a step) for ``--steps``
steps after 3 warm-up steps. ``--refine``: the refine stage's step
(``scripts/train_llff_refine.sh``: 32 patches of 64 px, the UNet at ngf 64
or ``--refine_network``, l1; with ``--refine_as_gan`` the GAN's update
pair, D at ndf 64 and the fake pool) on 20 random 504x378 views, with
cuDNN's
deterministic algorithms as ``train_refine`` runs it, in f32 as
``chip_smoke.py`` runs it (``--allow_tf32``: TF32 convolutions,
PyTorch's default for cuDNN). Each runs the graphed route, as the engine
runs it on the card (each eval view one CUDA-graph replay,
``train_steps_scan``'s chunk one replay a step, captured during the
warm-up), or with ``--eager`` the eager route (``train_steps``, the eval
chunk loop), and also prints where the host's time goes by operator
(``--host_top``). Each runs under ``torch.profiler`` and prints
the device time by kernel name, the wall time per image or step, the
device's busy time per image or step (the union of its kernels' and
copies' intervals, so kernels that overlap count once) and its busy
share (busy time / wall time), and the port's spans
(``nerfsr_torch/spans.py``) per image or step: count, seconds, self
seconds and parent, as the benchmark's traced runs read them. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from nerfsr_torch import spans

HR_WH = (504, 378)
FOCAL = 407.0


def _options(phase, preset="llff", **extra):
    from nerfsr_torch.config import default_options
    return default_options(phase, model="nerf_downX",
                           dataset_mode="llff_downX", fast_preset=preset,
                           img_wh=HR_WH, downscale=2, precision="mixed",
                           **extra)


def _serving(args):
    """(run, units, unit name): render ``--views`` views."""
    from nerfsr_torch.data.views import LLFFDownXViews
    from nerfsr_torch.models import create_model

    system = create_model(_options("test", args.preset), device="cuda")
    if args.eager:
        system.graphs = None
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

    system = create_model(_options("train", args.preset, batch_size=512,
                                   n_epochs=30, include_var=True,
                                   ds_method="avg"), device="cuda")
    teacher = system.init_params(seed=1)
    with torch.no_grad():
        for net in teacher.values():
            net.sigma.bias += 3.0
    buffer = LLFFDownXTrainViews.rendered(system, teacher, FOCAL, HR_WH, 2,
                                          2).ray_buffer("cuda")
    state = system.create_state(seed=0, steps_per_epoch=buffer["rgbs"]
                                .shape[0] // 512)
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = system.train_steps if args.eager else system.train_steps_scan
    steps(state, buffer, 3, gen)

    def run():
        steps(state, buffer, args.steps, gen)
    return run, args.steps, "step"


def _refine(args):
    """(run, units, unit name): ``--steps`` refine steps."""
    import numpy as np
    from nerfsr_torch.config import default_options
    from nerfsr_torch.models import create_model

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = args.allow_tf32
    opt = default_options("train", model="refine",
                          dataset_mode="llff_refine", img_wh=HR_WH,
                          batch_size=32, refine_with_l1=True,
                          refine_network=args.refine_network,
                          refine_as_gan=args.refine_as_gan)
    system = create_model(opt, device="cuda")
    rng = np.random.RandomState(0)
    w, h = HR_WH
    views = rng.rand(20, h, w, 3).astype(np.float32) * 2 - 1
    buffers = system.upload_buffers({
        "sr_imgs": views, "gt_imgs": views, "gt_img": views[0],
        "bboxes": np.tile(np.array([0, 0, w, h], np.int32), (20, 1))})
    state = system.create_state(seed=0, steps_per_epoch=1000)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.eager:
        system.graphs = None
    if args.refine_as_gan:
        gan = (system.create_gan_state(0), system.new_pool())

        def steps(state, buffers, n, gen):
            system.train_steps_scan_gan(state, *gan, buffers, n, gen)
    else:
        steps = system.train_steps_scan
    steps(state, buffers, 3, gen)

    def run():
        steps(state, buffers, args.steps, gen)
    return run, args.steps, "step"


def busy_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="profile training steps instead of serving")
    ap.add_argument("--refine", action="store_true",
                    help="profile the refine stage's training steps")
    ap.add_argument("--refine_network", default="unetgenerator",
                    choices=["unetgenerator", "maxpoolingmodel"])
    ap.add_argument("--refine_as_gan", action="store_true",
                    help="--refine: the GAN's update pair")
    ap.add_argument("--allow_tf32", action="store_true",
                    help="--refine: TF32 convolutions")
    ap.add_argument("--views", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--eager", action="store_true",
                    help="the eager route (no CUDA graphs), with the "
                         "host's time by operator")
    ap.add_argument("--host_top", type=int, default=25,
                    help="--eager: operators listed by host time")
    ap.add_argument("--preset", default="llff", choices=["llff", "parity"],
                    help="--fast_preset of the slice: llff, or parity "
                         "(coarse 64 + fine 64 samples)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    run, units, unit = (_refine if args.refine else
                        _training if args.train else _serving)(args)
    torch.cuda.synchronize()
    spans.reset()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # kernels and copies only: a user annotation (e.g. Optimizer.step, a
    # span) covers the kernels it encloses, gaps included
    cuda = torch.autograd.DeviceType.CUDA
    device_us = busy_us(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == cuda
        and not getattr(e, "is_user_annotation", False))
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == cuda
              and not getattr(e, "is_user_annotation", False)]
    route = "eager" if args.eager else "graphed"
    print(f"card: {card}")
    print(f"{unit}s {units} ({route}): wall {wall / units * 1e3:.1f} "
          f"ms/{unit} (under the profiler), device busy "
          f"{device_us / units / 1e3:.2f} ms/{unit}, busy share "
          f"{device_us / 1e6 / wall:.3f}")
    print(f"{'device ms/' + unit:>16} {'calls/' + unit:>12}  kernel")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:args.top]:
        print(f"{e.device_time_total / units / 1e3:16.3f} "
              f"{e.count / units:12.1f}  {e.key[:90]}")
    print(f"{'host ms/' + unit:>16} {'self ms':>8} {'calls/' + unit:>12}"
          "  span (parent)")
    for name, t in sorted(spans.totals().items(),
                          key=lambda kv: -kv[1]["seconds"]):
        print(f"{t['seconds'] / units * 1e3:16.3f} "
              f"{t['self_s'] / units * 1e3:8.3f} {t['count'] / units:12.1f}"
              f"  {name} ({t['parent']})")
    if args.eager:
        # the host's side: each operator's own time (without the
        # operators it calls), summed over its calls
        host = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CPU]
        total = sum(e.self_cpu_time_total for e in host)
        print(f"host: {total / units / 1e3:.2f} ms/{unit} of operator "
              f"time (self), of the {wall / units * 1e3:.1f} ms/{unit} "
              "wall")
        print(f"{'host ms/' + unit:>16} {'calls/' + unit:>12}  operator")
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[
                :args.host_top]:
            print(f"{e.self_cpu_time_total / units / 1e3:16.3f} "
                  f"{e.count / units:12.1f}  {e.key[:90]}")


if __name__ == "__main__":
    main()
