"""Render a split from a checkpoint and write an HTML gallery of it:
``python -m nerfsr_torch.infer`` (the JAX package's ``infer.py``)."""

from nerfsr_torch.config import parse_options, save_options
from nerfsr_torch.engine import test
from nerfsr_torch.utils.html import write_gallery


def main(argv=None):
    opt = parse_options("infer", argv)
    print(save_options(opt))
    out_dir = test(opt)
    page = write_gallery(out_dir, title=f"{opt.name} {opt.test_split}")
    print(f"[infer] gallery at {page}")


if __name__ == "__main__":
    main()
