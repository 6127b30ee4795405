"""Configuration: the option surface the port reads.

Port of ``nerfsr_tpu/config.py`` (its own copy: the port imports nothing
of the JAX package). The flags the serving slice reads keep the JAX
package's names and defaults, as do ``FAST_PRESETS``,
``apply_fast_preset``, ``_DATASET_DEFAULTS`` and ``check_config_guard``.
The JAX package's TPU-only flags (``--use_pallas*``, ``--pallas_mlp_bwd``,
``--pallas_interpret``, ``--mesh_devices``, ``--compilation_cache_dir``)
are accepted and ignored: on CUDA the kernels run wherever their JAX
counterparts could. The training flags of the supersampling path
(optimizer, schedule, loss weights, ``--randomized``, ``--ds_method``,
``--include_var``, ``--scan_steps``) keep their JAX names and defaults.
Flags that only checkpoints, data loading, the GAN, refine or multi-host
runs read come with the slices that read them.
"""

from __future__ import annotations

import argparse
import os

# --fast_preset expansions (the JAX package's validated config ladder)
FAST_PRESETS = {
    # forward-facing (LLFF/NDC) scenes only: NI=16 slim two-round
    # proposal + pad anneal + slim proposal net
    "llff": dict(fast_sampling=True, N_importance=16, n_prop=48,
                 n_prop_levels=2, n_prop2=24, prop_pad_anneal_frac=0.5,
                 prop_pad_final=0.0, prop_W=48, prop_D=3),
    "quality": dict(fast_sampling=True, N_importance=24, n_prop=48,
                    n_prop_levels=2, n_prop2=24, prop_W=48, prop_D=3),
    "blender": dict(fast_sampling=True, N_importance=48, n_prop=96,
                    n_prop_levels=2, n_prop2=48),
    "universal": dict(fast_sampling=True, N_importance=48, n_prop=96,
                      n_prop_levels=2, n_prop2=48),
    # the reference's exact coarse+fine sampling (no proposal MLP)
    "parity": dict(fast_sampling=False),
}


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser(phase: str) -> argparse.ArgumentParser:
    # full flag names only (see the JAX package's build_parser)
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        allow_abbrev=False)

    # ---- base options ----
    p.add_argument("--name", type=str, required=True)
    p.add_argument("--model", type=str, default="template")
    p.add_argument("--init_type", type=str, default="kaiming")
    p.add_argument("--init_gain", type=float, default=0.02)
    p.add_argument("--dataset_mode", type=str, default="template")
    p.add_argument("--dataset_root", type=str, required=True)
    p.add_argument("--img_wh", type=int, nargs=2, required=True)
    p.add_argument("--phase", type=str, default=phase,
                   choices=["train", "test", "infer"])
    p.add_argument("--ray_chunk", type=int, default=4096,
                   help="eval ray chunk")
    p.add_argument("--n_epochs", type=int, default=20)

    # ---- nerf model options ----
    p.add_argument("--mlp_network", type=str, default="vanilla_mlp")
    p.add_argument("--N_coarse", type=int, default=64)
    p.add_argument("--N_importance", type=int, default=64)
    p.add_argument("--lindisp", action="store_true")
    p.add_argument("--noise_std", type=float, default=0.0)
    p.add_argument("--white_bkgd", action="store_true", default=None)
    p.add_argument("--dim_rgb", type=int, default=3)
    p.add_argument("--dim_pos", type=int, default=3)
    p.add_argument("--dim_dir", type=int, default=3)
    p.add_argument("--deg_pos", type=int, default=10)
    p.add_argument("--deg_dir", type=int, default=4)
    p.add_argument("--color_activation", type=str, default="sigmoid",
                   choices=["none", "sigmoid"])
    p.add_argument("--sigma_activation", type=str, default="relu",
                   choices=["relu", "softplus"])
    p.add_argument("--downscale", type=int, default=2)
    p.add_argument("--no_xyz", action="store_true")
    p.add_argument("--no_logscale", action="store_true")
    p.add_argument("--D", type=int, default=8)
    p.add_argument("--W", type=int, default=256)
    p.add_argument("--skips", type=int, nargs="+", default=[4])
    p.add_argument("--stop_grad", type=str2bool, default=False)
    p.add_argument("--no_dir", action="store_true")
    p.add_argument("--gamma_correct", action="store_true")

    # ---- fast sampling and precision ----
    p.add_argument("--fast_preset", type=str, default=None,
                   choices=sorted(FAST_PRESETS))
    p.add_argument("--force_config", action="store_true")
    p.add_argument("--precision", type=str, default="mixed",
                   choices=["f32", "bf16", "mixed"],
                   help="mixed: bf16 MLP compute, f32 heads/composite")
    p.add_argument("--steps_per_epoch", type=int, default=0)
    p.add_argument("--fast_sampling", action="store_true")
    p.add_argument("--n_prop", type=int, default=64)
    p.add_argument("--n_prop_levels", type=int, default=1)
    p.add_argument("--n_prop2", type=int, default=32)
    p.add_argument("--prop_pad", type=float, default=0.01)
    p.add_argument("--prop_pad_anneal_frac", type=float, default=0.0)
    p.add_argument("--prop_pad_anneal", type=int, default=0)
    p.add_argument("--prop_pad_final", type=float, default=0.0)
    p.add_argument("--prop_D", type=int, default=4)
    p.add_argument("--prop_W", type=int, default=64)
    p.add_argument("--deg_prop", type=int, default=6)
    p.add_argument("--fast_uniform_frac", type=float, default=0.0)

    # ---- training ----
    p.add_argument("--batch_size", type=int, default=2048)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr_policy", type=str, default="exp")
    p.add_argument("--lr_final", type=float, default=5e-6)
    p.add_argument("--n_epochs_decay", type=int, default=10)
    p.add_argument("--lr_decay_epochs", type=int, default=10)
    p.add_argument("--lr_decay_gamma", type=float, default=0.1)
    p.add_argument("--grad_clip_val", type=float, default=0)
    p.add_argument("--grad_clip_type", type=str, default="norm",
                   choices=["norm", "value"])
    p.add_argument("--randomized", type=str2bool, default=True)
    p.add_argument("--lambda_coarse_mse", type=float, default=1.0)
    p.add_argument("--lambda_fine_mse", type=float, default=1.0)
    p.add_argument("--lambda_interlevel", type=float, default=1.0)
    p.add_argument("--use_var_loss", action="store_true")
    p.add_argument("--lambda_coarse_var", type=float, default=0.01)
    p.add_argument("--lambda_fine_var", type=float, default=0.01)
    p.add_argument("--use_depth_var_loss", action="store_true")
    p.add_argument("--lambda_coarse_depth_var", type=float, default=0.01)
    p.add_argument("--lambda_fine_depth_var", type=float, default=0.01)
    p.add_argument("--ds_method", type=str, default="lanc",
                   choices=["avg", "lanc"])
    p.add_argument("--include_var", action="store_true")
    p.add_argument("--scan_steps", type=int, default=20,
                   help="steps per train_steps call of the training "
                        "engine (not ported yet)")

    # ---- accepted and ignored (TPU-only in the JAX package) ----
    p.add_argument("--use_pallas", action="store_true")
    p.add_argument("--use_pallas_mlp", action="store_true")
    p.add_argument("--use_pallas_sampling", action="store_true")
    p.add_argument("--pallas_mlp_bwd", type=str, default="xla",
                   choices=["xla", "pallas"])
    p.add_argument("--pallas_interpret", action="store_true")
    p.add_argument("--mesh_devices", type=int, default=0)
    p.add_argument("--compilation_cache_dir", type=str, default="")
    return p


# dataset-mode -> default overrides for flags the user did not pass
_DATASET_DEFAULTS = {
    "blender": dict(white_bkgd=True, noise_std=0.0),
    "blender_downX": dict(white_bkgd=True, noise_std=0.0),
    "llff": dict(white_bkgd=False, noise_std=1.0),
    "llff_downX": dict(white_bkgd=False, noise_std=1.0),
    "llff_refine": dict(white_bkgd=False, noise_std=1.0, patch_len=64),
    "template": dict(),
}


def apply_fast_preset(opt, explicit=()):
    """Expand ``--fast_preset`` into its flag set, skipping any flag the
    user passed explicitly."""
    preset = getattr(opt, "fast_preset", None)
    if not preset:
        return opt
    for key, val in FAST_PRESETS[preset].items():
        if key not in explicit:
            setattr(opt, key, val)
    return opt


def check_config_guard(opt):
    """Refuse pad-anneal-to-zero on white-background / 360-degree scenes
    (measured by the JAX package to lose 3-7 dB) unless
    ``--force_config``; warn on a sample-starved 360-degree config."""
    anneal_on = (getattr(opt, "prop_pad_anneal", 0) > 0
                 or getattr(opt, "prop_pad_anneal_frac", 0.0) > 0)
    anneals_away = anneal_on and getattr(opt, "prop_pad_final",
                                         0.0) < 0.005
    is_360 = (bool(getattr(opt, "white_bkgd", False))
              or str(getattr(opt, "dataset_mode",
                             "")).startswith("blender"))
    if (getattr(opt, "fast_sampling", False) and anneals_away and is_360
            and not getattr(opt, "force_config", False)):
        raise SystemExit(
            "[config] REFUSING: --prop_pad_anneal*/--prop_pad_final~0 "
            "with a white-background/360-degree (blender) dataset; use "
            "`--fast_preset blender`, or pass --force_config to run it "
            "anyway.")
    if (getattr(opt, "fast_sampling", False) and is_360
            and getattr(opt, "N_importance", 64) < 32):
        print("[config] WARNING: --fast_sampling with N_importance "
              f"{opt.N_importance} on a 360-degree/white-bkgd scene is "
              "sample-starved (the blender pick is N_importance 48 -- "
              "`--fast_preset blender`).")
    return opt


def parse_options(phase: str, argv=None):
    """Parse argv into a flat options namespace."""
    parser = build_parser(phase)
    opt = parser.parse_args(argv)
    raw = argv if argv is not None else os.sys.argv[1:]
    explicit = {a.split("=")[0].lstrip("-") for a in raw
                if a.startswith("--")}
    overrides = _DATASET_DEFAULTS.get(opt.dataset_mode, {})
    if opt.white_bkgd is None:
        opt.white_bkgd = overrides.get("white_bkgd", False)
    for key, val in overrides.items():
        if key != "white_bkgd" and key not in explicit:
            setattr(opt, key, val)
    apply_fast_preset(opt, explicit)
    check_config_guard(opt)
    opt.isTrain = phase == "train"
    opt.isTest = phase == "test"
    opt.isInfer = phase == "infer"
    return opt


def default_options(phase: str = "train", **overrides):
    """An options namespace built programmatically: an empty command line
    with the required flags filled, then ``overrides`` (explicit overrides
    win over preset values, preset values over defaults)."""
    argv = ["--name", overrides.pop("name", "exp"),
            "--dataset_root", overrides.pop("dataset_root", "."),
            "--img_wh",
            *[str(x) for x in overrides.pop("img_wh", (64, 64))]]
    if "dataset_mode" in overrides:
        argv += ["--dataset_mode", overrides.pop("dataset_mode")]
    opt = parse_options(phase, argv)
    for k, v in overrides.items():
        if not hasattr(opt, k):
            raise KeyError(f"unknown option: {k}")
        setattr(opt, k, v)
    if overrides.get("fast_preset"):
        apply_fast_preset(opt, explicit=set(overrides) - {"fast_preset"})
    check_config_guard(opt)
    return opt
