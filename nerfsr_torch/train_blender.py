"""Train on a Blender scene with the port: ``python -m
nerfsr_torch.train_blender``.

As ``python -m nerfsr_torch.train``, except that for the ``blender`` and
``blender_downX`` datasets the first 1000 steps draw from the centre-
cropped ``train_crop`` split (``--precrop_frac``): NeRF's warm-up against
a collapse to the white background, as the JAX package's
``train_blender.py`` does. Example, NeRF-SR x2 on a NeRF-synthetic scene
(``scripts/train_blender_downX.sh``)::

    python -m nerfsr_torch.train_blender --name lego-x2 \\
        --model nerf_downX --dataset_mode blender_downX \\
        --dataset_root <scene> --img_wh 200 200 --downscale 2 \\
        --batch_size 512 --N_coarse 64 --N_importance 64
"""

from nerfsr_torch.config import parse_options, save_options
from nerfsr_torch.engine import train

WARMUP_ITERS = 1000


def main(argv=None):
    opt = parse_options("train", argv)
    print(save_options(opt))
    warmup = "train_crop" if opt.dataset_mode.startswith("blender") \
        else None
    return train(opt, warmup_mode=warmup, warmup_iters=WARMUP_ITERS)


if __name__ == "__main__":
    main()
