"""Train NeRF-SR with the port: ``python -m nerfsr_torch.train``.

The flags are those of the JAX package's ``train.py``, plus ``--device``
(``cuda`` by default; ``cpu`` runs the plain versions). With
``--train_crop`` the first 1000 steps draw from the ``train_crop`` split
(the Blender centre-crop warm-up). Example, the supersampling model on a
COLMAP scene (``scripts/train_llff_downX_fast.sh``)::

    python -m nerfsr_torch.train --name fern-x2 --model nerf_downX \\
        --dataset_mode llff_downX --dataset_root <scene> --img_wh 504 378 \\
        --downscale 2 --fast_preset llff --precision mixed --batch_size 512
"""

from nerfsr_torch.config import parse_options, save_options
from nerfsr_torch.engine import train


def main(argv=None):
    opt = parse_options("train", argv)
    print(save_options(opt))
    return train(opt, warmup_mode="train_crop" if opt.train_crop else None)


if __name__ == "__main__":
    main()
