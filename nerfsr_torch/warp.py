"""Cross-view correspondences for the refine stage:
``python -m nerfsr_torch.warp``.

The arguments of the JAX package's ``warp.py``, plus ``--device``
(``cuda`` by default; ``cpu`` runs on the CPU). Reads the
``{i}-fine-depth-ori.npz`` depths that ``python -m nerfsr_torch.test``
writes for a ``nerf_downX`` checkpoint and writes ``{i}_locs.npz`` (read
by the ``llff_refine`` dataset) and ``{i}-wrapped.png`` beside them::

    python -m nerfsr_torch.warp --dataset_root <llff_scene> \\
        --result_dir ./results/<name>/test_train_30 --img_wh 504 378
"""

import argparse
import time


def main(argv=None):
    p = argparse.ArgumentParser(allow_abbrev=False)
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--result_dir", required=True,
                   help="dir holding {i}-fine-depth-ori.npz from test")
    p.add_argument("--img_wh", type=int, nargs=2, required=True)
    p.add_argument("--spheric_poses", action="store_true")
    p.add_argument("--ref_idx", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the card) or cpu")
    args = p.parse_args(argv)

    from nerfsr_torch.ops.warp import generate_correspondences

    t0 = time.perf_counter()
    written = generate_correspondences(
        args.dataset_root, args.result_dir, tuple(args.img_wh),
        spheric_poses=args.spheric_poses, ref_idx=args.ref_idx,
        device=args.device)
    ms = (time.perf_counter() - t0) * 1e3 / max(1, len(written))
    print(f"wrote locs/wrapped for views: {written} ({ms:.1f} ms/view)")
    return written


if __name__ == "__main__":
    main()
