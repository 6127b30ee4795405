"""Configuration: the option surface the port reads.

Port of ``nerfsr_tpu/config.py`` (its own copy: the port imports nothing
of the JAX package). Every flag the port reads keeps the JAX package's
name and default, as do ``FAST_PRESETS``, ``apply_fast_preset``,
``_DATASET_DEFAULTS`` and ``check_config_guard``: the model and render
flags, the training flags (optimizer, schedule, loss weights,
``--randomized``, ``--ds_method``, ``--include_var``, ``--scan_steps``),
and the engine's (experiment and checkpoint directories, resume,
``--init_weights``, ``--fix_layers``, the save/val/vis/log cadences, the
dataset options of ``llff``/``llff_downX`` and ``blender_downX``
(``--rand_dir``), ``--train_crop`` with ``--precrop_frac``,
``--test_split``). ``--device``
(default ``cuda``) is the port's own: ``cpu`` runs the plain PyTorch
versions on the CPU, as ``JAX_PLATFORMS=cpu`` does for the JAX package.
The JAX package's TPU-only flags (``--use_pallas*``, ``--pallas_mlp_bwd``,
``--pallas_interpret``, ``--compilation_cache_dir``) are accepted and
ignored: on CUDA the kernels run wherever their JAX counterparts could.
So are its compat no-ops (``--accelerator``, ``--num_threads``,
``--eval_batch_size``, ``--point_chunk``, ``--embedding``, ``--with_sr``,
``--n_layers_D``, ``--profile_port``) and ``--verbose``; ``--suffix``
renames ``--name`` as it does there, so every JAX command line parses.
The auxiliary training paths' flags (``--with_ref`` with
``--ref_freq``/``--ref_idx``/``--all_ref``, ``--patch_size`` with the
depth-Laplacian and VGG weights, ``--with_netD`` with the GAN's,
``--reg_patch`` with its length, cadence and weight) keep the JAX
package's names and defaults. The refine stage's flags (the refine
model, ``llff_refine`` dataset and network options, ``--refine_as_gan``
with ``--lambda_L1``) keep the JAX package's names and defaults too. So
do the data-parallel flags: ``--mesh_devices`` (ranks, one card each; 0
means every visible card) and the multi-process ``--coordinator``,
``--num_processes`` and ``--process_id`` (``nerfsr_torch/parallel/
mesh.py``).
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
    p.add_argument("--accelerator", type=str, default="dp",
                   choices=["dp", "ddp"], help="accepted and ignored")
    p.add_argument("--name", type=str, required=True)
    p.add_argument("--checkpoints_dir", type=str, default="./checkpoints")
    p.add_argument("--ckpt_backend", type=str, default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="msgpack: atomic single-file checkpoints (the "
                        "port's only backend; orbax is refused)")
    p.add_argument("--summary_dir", type=str, default="./runs")
    p.add_argument("--seed", type=int, default=99)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu (the plain versions)")
    p.add_argument("--model", type=str, default="template")
    p.add_argument("--init_type", type=str, default="kaiming")
    p.add_argument("--init_gain", type=float, default=0.02)
    p.add_argument("--dataset_mode", type=str, default="template")
    p.add_argument("--dataset_root", type=str, required=True)
    p.add_argument("--sisr_path", type=str, default=None)
    p.add_argument("--num_threads", type=int, default=4,
                   help="accepted and ignored: batches are drawn on the "
                        "device")
    p.add_argument("--eval_batch_size", type=int, default=1,
                   help="accepted and ignored: eval renders whole images "
                        "in --ray_chunk chunks")
    p.add_argument("--max_dataset_size", type=float, default=float("inf"))
    p.add_argument("--img_wh", type=int, nargs=2, required=True)
    p.add_argument("--use_pixel_centers", type=str2bool, default=True)
    p.add_argument("--patch_size", type=int, default=1)
    p.add_argument("--phase", type=str, default=phase,
                   choices=["train", "test", "infer"])
    p.add_argument("--load_epoch", type=str, default="latest")
    p.add_argument("--verbose", action="store_true",
                   help="accepted and ignored (the JAX package's NaN "
                        "guard, jax_debug_nans)")
    p.add_argument("--suffix", default="", type=str,
                   help="appended to --name as _{suffix}, formatted with "
                        "the options ({model}_{downscale})")
    p.add_argument("--ray_chunk", type=int, default=4096,
                   help="eval ray chunk")
    p.add_argument("--point_chunk", type=int, default=2048 * 128,
                   help="accepted and ignored: the MLP batch is never "
                        "split")

    if phase == "train":
        p.add_argument("--print_freq", type=int, default=10)
        p.add_argument("--vis_freq", type=int, default=10)
        p.add_argument("--vis_epoch_freq", type=int, default=5)
        p.add_argument("--val_freq", type=int, default=10)
        p.add_argument("--val_epoch_freq", type=int, default=1)
        p.add_argument("--save_epoch_freq", type=int, default=1)
        p.add_argument("--continue_train", action="store_true")
        p.add_argument("--init_weights", type=str, default=None)
        p.add_argument("--init_weights_keys", type=str, default=".+")
        p.add_argument("--fix_layers", type=str, default=None)
        p.add_argument("--precrop_frac", type=float, default=0.5,
                       help="train_crop: the centre window's half-size "
                            "as a fraction of the image's")
        p.add_argument("--keep_last", action="store_true",
                       help="count the final partial batch in the epoch")
        p.add_argument("--train_split", type=str, default="train")
        p.add_argument("--val_split", type=str, default="val")
        p.add_argument("--val_epoch_split", type=str, default="test_train")
    else:
        p.add_argument("--results_dir", type=str, default="./results/")
    p.add_argument("--test_split", type=str, default="test")
    p.add_argument("--n_epochs", type=int, default=20)

    # ---- nerf model options ----
    p.add_argument("--mlp_network", type=str, default="vanilla_mlp",
                   help="vanilla_mlp, or neutex_mlp (a two-layer, "
                        "full-width direction branch)")
    p.add_argument("--embedding", type=str, default="positional_encoding",
                   choices=["positional_encoding"])
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
    p.add_argument("--with_sr", action="store_true",
                   help="accepted and ignored (SISR supervision follows "
                        "--sisr_path)")
    p.add_argument("--scan_steps", type=int, default=20,
                   help="steps per train_steps call of the training "
                        "engine; losses are read once per chunk")
    p.add_argument("--log_every", type=int, default=0,
                   help="train-loss log cadence (0 = --print_freq)")
    p.add_argument("--train_crop", action="store_true")

    # ---- the auxiliary training paths ----
    # --with_ref: the reference view's HR rays beside each batch
    p.add_argument("--with_ref", action="store_true")
    p.add_argument("--no_ref_loss", action="store_true")
    p.add_argument("--ref_freq", type=int, default=1)
    p.add_argument("--all_ref", action="store_true")
    # patch mode (--patch_size > 1): depth Laplacian and VGG
    p.add_argument("--lambda_coarse_depth_lap", type=float, default=0.0)
    p.add_argument("--lambda_fine_depth_lap", type=float, default=0.0)
    p.add_argument("--lambda_coarse_vgg", type=float, default=0.0)
    p.add_argument("--lambda_fine_vgg", type=float, default=0.0)
    p.add_argument("--bilateral_gamma", type=float, default=0.1)
    # --with_netD: the adversarial patch update
    p.add_argument("--with_netD", action="store_true")
    p.add_argument("--dis_network", type=str, default="nlayerdiscriminator")
    p.add_argument("--ndf_dis", type=int, default=64)
    p.add_argument("--n_layers_D", type=int, default=3,
                   help="accepted and ignored: the discriminator's depth "
                        "follows --patch_len")
    p.add_argument("--lambda_gan", type=float, default=0.005)
    p.add_argument("--use_grad", action="store_true")
    p.add_argument("--gan_lr", type=float, default=5e-4)
    p.add_argument("--gan_mode", type=str, default="vanilla",
                   choices=["vanilla", "lsgan", "wgangp"])
    p.add_argument("--start_epoch", type=int, default=0)
    p.add_argument("--gan_iter", type=int, default=10)
    # --reg_patch: total variation of a rendered HR patch
    p.add_argument("--reg_patch", action="store_true")
    p.add_argument("--reg_patch_len", type=int, default=1)
    p.add_argument("--reg_patch_freq", type=int, default=5)
    p.add_argument("--reg_lambda_tv", type=float, default=1.0)

    # ---- llff / llff_downX dataset options ----
    p.add_argument("--spheric_poses", action="store_true")
    p.add_argument("--val_num", type=int, default=1)
    p.add_argument("--unified_dir", action="store_true")
    p.add_argument("--use_subset", action="store_true")
    p.add_argument("--subset_num", type=int, default=20)

    # ---- blender_downX dataset options ----
    p.add_argument("--rand_dir", action="store_true",
                   help="a random offset within each pixel for its ray")

    # ---- refine model options ----
    p.add_argument("--refine_network", type=str, default="unetgenerator")
    p.add_argument("--refine_with_mse", action="store_true")
    p.add_argument("--refine_with_l1", action="store_true")
    p.add_argument("--refine_with_vgg", action="store_true")
    p.add_argument("--refine_with_grad", action="store_true")
    p.add_argument("--lambda_refine_vgg", type=float, default=1.0)
    p.add_argument("--lambda_refine_l1", type=float, default=1.0)
    p.add_argument("--lambda_refine_mse", type=float, default=10.0)
    p.add_argument("--lambda_refine_grad", type=float, default=1.0)
    p.add_argument("--refine_as_gan", action="store_true")
    p.add_argument("--lambda_L1", type=float, default=100.0)
    p.add_argument("--vgg_weights", type=str, default=None)
    p.add_argument("--patch_len", type=int, default=32)

    # ---- llff_refine dataset options ----
    p.add_argument("--syn_dataroot", type=str, default=None)
    p.add_argument("--ref_idx", type=int, default=0)
    p.add_argument("--aug_num", type=int, default=200)
    p.add_argument("--distort_scale", type=float, default=0.3)
    p.add_argument("--num_ref_patches", type=int, default=8)
    p.add_argument("--with_gt_patch", action="store_true")
    p.add_argument("--ref_offset", type=int, default=64)
    p.add_argument("--data_num", type=int, default=500000)
    p.add_argument("--test_img_split", type=int, default=4)

    # ---- refine network options ----
    p.add_argument("--learn_residual", action="store_true")
    p.add_argument("--input_nc", type=int, default=27,
                   help="UNet input channels; must equal "
                        "3*(1+num_ref_patches)")
    p.add_argument("--output_nc", type=int, default=3)
    p.add_argument("--norm", type=str, default="batch",
                   help="batch, instance, or anything else for none")
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--num_downs", type=int, default=6)
    p.add_argument("--not_use_ref", action="store_true")

    # ---- accepted and ignored (TPU-only in the JAX package) ----
    p.add_argument("--use_pallas", action="store_true")
    p.add_argument("--use_pallas_mlp", action="store_true")
    p.add_argument("--use_pallas_sampling", action="store_true")
    p.add_argument("--pallas_mlp_bwd", type=str, default="xla",
                   choices=["xla", "pallas"])
    p.add_argument("--pallas_interpret", action="store_true")
    p.add_argument("--compilation_cache_dir", type=str, default="")
    p.add_argument("--profile_port", type=int, default=0,
                   help="accepted and ignored (a jax.profiler server port "
                        "in the JAX package)")

    # ---- data parallelism (nerfsr_torch/parallel/mesh.py) ----
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="ranks of the data-parallel world, one card each "
                        "(0 = every visible card); above 1 without "
                        "--num_processes the ranks are spawned here")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-process: rank 0's host:port for "
                        "torch.distributed's TCP rendezvous")
    p.add_argument("--num_processes", type=int, default=0,
                   help="multi-process: the world size (0 = one process, "
                        "no process group)")
    p.add_argument("--process_id", type=int, default=-1,
                   help="multi-process: this process's rank")
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
    if opt.suffix:
        opt.name = opt.name + "_" + opt.suffix.format(**vars(opt))
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


def save_options(opt):
    """Write the options to ``{checkpoints_dir}/{name}/{phase}_opt.txt``
    and ``.json`` (on the master rank only: ``--process_id`` 0 or none);
    returns the text."""
    import json
    d = dict(sorted(vars(opt).items()))
    msg = "\n".join(["----------------- Options ---------------"]
                    + [f"{str(k):>25}: {v}" for k, v in d.items()]
                    + ["----------------- End -------------------"])
    if getattr(opt, "num_processes", 0) and opt.process_id > 0:
        return msg
    expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
    os.makedirs(expr_dir, exist_ok=True)
    with open(os.path.join(expr_dir, f"{opt.phase}_opt.txt"), "w") as f:
        f.write(msg + "\n")
    with open(os.path.join(expr_dir, f"{opt.phase}_opt.json"), "w") as f:
        json.dump({k: v if isinstance(v, (int, float, str, bool, list,
                                           type(None))) else str(v)
                   for k, v in d.items()}, f)
    return msg
