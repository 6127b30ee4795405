"""Refine a split from a checkpoint: ``python -m nerfsr_torch.test_refine``.

Tiles each image of ``--test_split``, refines the tiles, stitches them
and writes ``{results_dir}/{name}/{test_split}_{load_epoch}/
{i}-sr-refine.png`` ([SR | refined | truth]), then prints the mean
SSIM/PSNR of the input and of the refined image, as the JAX package's
``test_refine.py`` does (``scripts/test_llff_refine.sh``).
"""

from nerfsr_torch.config import parse_options, save_options
from nerfsr_torch.engine import test_refine


def main(argv=None):
    opt = parse_options("test", argv)
    print(save_options(opt))
    return test_refine(opt)


if __name__ == "__main__":
    main()
