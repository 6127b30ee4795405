"""Train the refine stage with the port: ``python -m
nerfsr_torch.train_refine``.

The flags are those of the JAX package's ``train_refine.py``, plus
``--device`` (``cuda`` by default; ``cpu`` runs on the CPU). Example,
``scripts/train_llff_refine.sh`` after ``python -m nerfsr_torch.warp``::

    python -m nerfsr_torch.train_refine --name llff-refine-fern \\
        --dataset_mode llff_refine --dataset_root <scene> \\
        --img_wh 504 378 --batch_size 32 --model refine --n_epochs 3 \\
        --n_epochs_decay 0 --lr_policy exp --lr 5e-4 --lr_final 5e-6 \\
        --print_freq 100 --vis_freq 1000 --val_freq 1000 \\
        --save_epoch_freq 1 --val_epoch_freq 1 \\
        --syn_dataroot <results>/test_train_30 --refine_with_l1
"""

from nerfsr_torch.config import parse_options, save_options
from nerfsr_torch.engine import train_refine


def main(argv=None):
    opt = parse_options("train", argv)
    print(save_options(opt))
    return train_refine(opt)


if __name__ == "__main__":
    main()
