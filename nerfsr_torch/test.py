"""Render a split from a checkpoint: ``python -m nerfsr_torch.test``.

Writes ``{results_dir}/{name}/{test_split}_{load_epoch}/``: the LR and HR
(``{i}-fine-ori.png``) strips, the depth maps
(``{i}-fine-depth[-ori].npz`` and their PNGs) that the refine stage
reads, and a GIF per strip kind, as the JAX package's ``test.py`` does.
"""

from nerfsr_torch.config import parse_options, save_options
from nerfsr_torch.engine import test


def main(argv=None):
    opt = parse_options("test", argv)
    print(save_options(opt))
    test(opt)


if __name__ == "__main__":
    main()
